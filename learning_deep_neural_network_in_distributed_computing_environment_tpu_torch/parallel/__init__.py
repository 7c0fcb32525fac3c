"""The inner mesh axes of a worker (port of the JAX package's
``parallel/``): tensor parallelism over ``model`` (``tp.py``), ZeRO-3 /
FSDP over ``fsdp`` (``fsdp.py``), sequence parallelism over ``seq``
(``sp.py``), pipeline parallelism over ``pipe`` (``pp.py``), the MoE
layers' collectives over ``expert`` (``ep.py``), and the plan
that places one rank's share of a worker's parameters (``shards.py``).
Their collectives run on the rank grid's gloo groups (``mesh.Grid``),
staged through host memory as every collective of the port is."""
