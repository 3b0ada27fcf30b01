from vlite_fast.parallel import mesh, halo, sharded_pipeline  # noqa: F401
