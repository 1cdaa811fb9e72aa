"""Worker process of tests/test_torch_multihost.py: the port's sharded BA
across processes.

Each process joins a gloo process group (torch.distributed), holds two
local CPU shards, and forms with the others one global mesh
(Mesh(["cpu", "cpu"], group)): with 2 processes, 4 shards, and every
Mesh.all_sum crosses the process boundary. On the problem the parent wrote
(a pickle of ba_problem_from_numpy's field dict) it runs:
  1. ONE normal-equation assembly (scene, and text when the problem has
     text rows), which the parent holds tightly against the same
     assembly in one process;
  2. the full sharded LM (solve_ba_sharded, 6 iterations), which the parent
     holds by final cost;
  3. batched ORB extraction of the frames in the pickle, gathered across
     the processes.
Rank 0 writes the results.

    python torch_multihost_worker.py <rank> <world> <problem.pkl> <out.npz>

The TCP port of the rendezvous comes from TEXTSLAM_MH_PORT, the process
group's timeout in seconds from TEXTSLAM_MH_TIMEOUT.
"""

import datetime
import os
import pickle
import sys


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    in_path, out_path = sys.argv[3], sys.argv[4]
    port = os.environ["TEXTSLAM_MH_PORT"]
    timeout = float(os.environ.get("TEXTSLAM_MH_TIMEOUT", "600"))
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout))
    try:
        from textslam_tpu_torch.parallel import ba_sharded, features
        from textslam_tpu_torch.parallel.mesh import Mesh
        from textslam_tpu_torch.solver import ba

        with open(in_path, "rb") as f:
            payload = pickle.load(f)
        problem = ba.ba_problem_from_numpy(payload["problem"], device="cpu")
        mesh = Mesh(["cpu", "cpu"], group=dist.group.WORLD)
        assert mesh.size == 2 * world

        Hcc, bc, _, Hll, bl, cost0 = ba_sharded.sharded_scene_normal_eqs(problem, mesh, 2.447)
        if problem.text is not None:
            H2, b2, _, _, _, c2 = ba_sharded.sharded_text_normal_eqs(problem, mesh, 3.0)
            Hcc, bc, cost0 = Hcc + H2, bc + b2, cost0 + c2
        st = ba_sharded.solve_ba_sharded(problem, mesh, n_iters=6)
        kp = features.batched_extract(torch.as_tensor(payload["frames"]), mesh,
                                      n_features=200, n_levels=2)
        if rank == 0:
            out = dict(Hcc=Hcc, bc=bc, Hll_d=Hll[:, 0, 0], bl_d=bl[:, 0], cost0=cost0,
                       poses=st.poses, rho=st.rho, cost=st.cost, kp_uv=kp.uv,
                       kp_desc=kp.desc, kp_valid=kp.valid)
            if st.theta is not None:
                out["theta"] = st.theta
            tmp = out_path + ".tmp.npz"
            np.savez(tmp, **{k: v.numpy() for k, v in out.items()})
            os.replace(tmp, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
