"""One host of a multi-host mapping run: joins the hosts' process group
at the coordinator and maps this host's round-robin batch share
(distributed.run_host). Host 0, or any process, then merges the hosts'
files with distributed.merge_host_outputs.

Usage: python -m minialign_tpu_torch.parallel.dist_host \\
           <host_id> <n_hosts> <coordinator host:port> <out> <argv...>

The counterpart of the JAX package's tests/tools/dist_host.py. An empty
coordinator maps without joining a group. The device is
$MINIALIGN_TORCH_DEVICE (default cuda).
"""

import sys


def main() -> int:
    host_id, n_hosts = int(sys.argv[1]), int(sys.argv[2])
    coordinator, out_path = sys.argv[3], sys.argv[4]
    from . import distributed
    distributed.run_host(sys.argv[5:], out_path, host_id, n_hosts,
                         coordinator=coordinator or None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
