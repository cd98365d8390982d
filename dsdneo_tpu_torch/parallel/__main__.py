"""``torchrun --nproc-per-node N -m dsdneo_tpu_torch.parallel [--cpu]``:
the multi-chip dry run (``mesh.dryrun_rank``) on every rank of a torchrun
world, one card a rank (``LOCAL_RANK``) under NCCL, or the CPU under
gloo with ``--cpu``; rank 0 prints its summary."""

import sys

from dsdneo_tpu_torch.parallel import dist
from dsdneo_tpu_torch.parallel.mesh import dryrun_rank


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mesh = dist.mesh_from_env(device="cpu" if "--cpu" in argv else None)
    try:
        out = dryrun_rank(mesh)
    finally:
        dist.close_mesh(mesh)
    if mesh.rank == 0:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
