"""Data parallelism over a device mesh (the port of the JAX package's
parallel/): mesh.py builds meshes of CUDA devices (or of CPU entries, for
the tests), turbo_dp.py the sharded TurboRANS steps, dp.py the compat
codecs' sharded steps, distributed.py the multi-host process group, and
dryrun.py the multi-device dry run."""
from .mesh import device_count, get_mesh, make_mesh, make_mesh_2level
from .dp import sharded_fse_step, sharded_decode, sharded_encode
