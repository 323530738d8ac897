"""One rank of the data-parallel tests on the CPU (gloo).

    python _torch_dp_worker.py cases <rank> <world> <port> <in.npz> <out.npz>
    python _torch_dp_worker.py multihost <rank> <world> <port> - <out.npz>

``cases`` brings the group up from torchrun's environment variables
(``make_mesh``) and runs every case of ``_torch_dp_cases`` from the
weights in ``in.npz``; ``multihost`` brings it up over TCP
(``init_multihost``), builds the flat and the ``("host", "dp")`` meshes and
runs one PPO-Lag train step on the flat one. The results go to
``out.npz``. Imports only ``torch``, ``numpy`` and ``fsrl_torch``.
"""

import os
import sys

mode, rank, world, port, src, dst = sys.argv[1:7]
rank, world = int(rank), int(world)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from fsrl_torch.parallel.mesh import (env_sharding,  # noqa: E402
                                      init_multihost, make_mesh,
                                      make_multihost_mesh, replicated)

if mode == "cases":
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=port)
    mesh = make_mesh(backend="gloo", device="cpu")
    import _torch_dp_cases as cases  # noqa: E402
    weights = dict(np.load(src))
    out = cases.run_all(weights, mesh)
else:
    init_multihost(f"localhost:{port}", world, rank, device="cpu")
    flat = make_multihost_mesh(device="cpu")
    hier = make_multihost_mesh(hierarchical=True, device="cpu")
    import _torch_dp_cases as cases  # noqa: E402
    case = "ppo_lag_dp_blocks_2"
    res = cases.onpolicy_step(case, cases.init_weights(case), flat)
    out = dict(flat_shape=np.array(flat.shape),
               flat_names=np.array(flat.mesh_dim_names),
               hier_shape=np.array(hier.shape),
               hier_names=np.array(hier.mesh_dim_names),
               world=np.array(dist.get_world_size()),
               placements=np.array([str(env_sharding(flat)),
                                    str(replicated(hier))]),
               loss=res["metric/loss/total"], flat_params=res["flat"])
np.savez(dst, **out)
dist.destroy_process_group()
print(f"DPOK {rank}", flush=True)
