"""Traffic modes: what one kind of cell does between the frame's steps
(run.py). A traffic file's "mode" key names modes/<mode>.py, which
spec.mode() loads by that name; the frame names no mode, and a mode
names no cell, configuration or metric.

A mode file defines `CHECKS`, the names of the numbers that decide
`correct` (a cell's limits/<cell>.json has exactly these keys), and
`Mode(cfg, mix, seed, device, workdir, sample, n_blocks)`, whose hooks
the frame calls in this order:

    inputs()        inputs made from the seed under `workdir`
    prepare()       the port's imports; the CLI's argv, options, params
    index()         what is indexed, built (timed: index_build_s)
    engine()        the engine, made as cli.main makes it on one card
    writer(sink)    the writer and its header, into the frame's sink
                    (counted and hashed; `sink.cap`, where not None,
                    keeps what is written)
    warm_up()       the warm-up batch, not counted
    open_window(spans, counters, traced) -> (batches, process)
                    the window's batch iterator, and process(batch) ->
                    (reads, bases) that maps, writes and times a batch,
                    with spans.add() for the harness's spans
                    (trace.SPAN_ORDER) and counters for the metrics
    end_window(counters)
                    after the window: counts read, patches undone
    close()         the program's state freed before the judge
    judge() -> (checks, reads judged, reads failed)
"""
