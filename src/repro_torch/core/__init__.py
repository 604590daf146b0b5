"""SPA pruning core of the port: graph, mask propagation, groups,
importance, the pruner and OBSPA (the reference's ``repro/core``)."""
