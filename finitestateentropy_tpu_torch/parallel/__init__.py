"""Data parallelism over a device mesh (the port of the JAX package's
parallel/): mesh.py builds meshes of CUDA devices (or of CPU entries, for
the tests), turbo_dp.py the sharded TurboRANS steps, distributed.py the
multi-host process group, and dryrun.py the multi-device dry run.  The
compat codecs' sharded step (the JAX package's parallel/dp.py) is not
ported yet."""
from .mesh import device_count, get_mesh, make_mesh, make_mesh_2level
