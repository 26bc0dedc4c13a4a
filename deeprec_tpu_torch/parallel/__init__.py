"""Multi-process training support. Only `elastic.EXIT_RESCALE` is ported
so far (ROADMAP queue A item 8 ports the rest)."""
