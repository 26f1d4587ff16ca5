from .elastic import shrink_mesh, reshard, run_with_retries
