"""Multi-device parallelism (counterpart of ``parallel/``): the mesh, the
collectives the model code issues, and context-parallel ring attention."""
