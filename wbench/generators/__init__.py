"""Graph generators, one module each, found by the name a configuration's
``generator`` key gives; each has one entry, ``generate(rng, ...)``, that
returns a ``wbench.graphs.EdgeList``.  The ones copied from the port are
frozen: a later change to the port's generators cannot change the data."""
