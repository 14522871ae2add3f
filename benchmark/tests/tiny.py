"""A cell cut to a size that the CPU runs in seconds, for the tests: the
ecoli-pacbio configuration and the map mix with a 40 kb genome and six
reads of ~2 kb."""

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cell(seed=2**31 + 7):
    with open(os.path.join(HERE, "configs", "ecoli-pacbio.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", "map.json")) as f:
        mix = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["genome"]["length"] = 40_000
    cfg["reads"].update(len_mean=2000, len_sd=300)
    mix["pool_mbases"] = 0.012
    mix["warmup_bases"] = 2000
    return cfg, mix


def run(tmp, seed=2**31 + 7, traced=False, cfg_mix=None):
    """One run of the tiny cell (or of `cfg_mix`, a (configuration, mix)
    pair) on the CPU: (checks, judged, result)."""
    os.environ["MINIALIGN_SCHED_WORKERS"] = "1"
    import torch
    torch.set_num_threads(1)
    from benchmark import run as brun
    cfg, mix = cell() if cfg_mix is None else cfg_mix
    r = brun.run_cell(cfg, mix, seed, 0.0, traced, "cpu", str(tmp),
                      sample=(6, 2), n_blocks=4)
    return r["checks"], r["judged"], r
