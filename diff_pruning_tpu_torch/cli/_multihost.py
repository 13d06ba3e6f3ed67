"""The shared ``--multihost`` flags of the CLIs (counterpart of
``diff_pruning_tpu/cli/_multihost.py``): the torchrun/accelerate-launch
equivalent (scripts/sample_ddpm_cifar10_pretrained_distributed.sh:1).

Every process runs the same command with ``--multihost``: under torchrun
the rendezvous and the rank come from its environment; otherwise give
``--coordinator_address``, ``--num_processes`` and ``--process_id``. A CLI
calls :func:`maybe_init_distributed` right after parsing its arguments,
before it touches the card.
"""

from __future__ import annotations


def add_multihost_args(parser) -> None:
    parser.add_argument(
        "--multihost", action="store_true",
        help="join a torch.distributed group (NCCL on the card, gloo on the CPU) and split "
             "every batch by rows over its processes; run the same command in every "
             "process, e.g. under torchrun --nproc_per_node N")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of process 0 (from torchrun's environment when "
                             "omitted)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def maybe_init_distributed(args):
    """The data mesh of a ``--multihost`` run, or None: joins the process
    group through :func:`init_distributed` (which raises when this process
    already has one); the address flags without ``--multihost`` raise. On
    the card rank 0 builds the kernels while the other ranks wait, then they
    load its builds."""
    given = (args.coordinator_address, args.num_processes, args.process_id)
    if not args.multihost:
        if any(v is not None for v in given):
            raise ValueError("--coordinator_address, --num_processes and --process_id "
                             "need --multihost")
        return None
    from ..parallel.mesh import init_distributed

    mesh = init_distributed(*given, device="cpu" if args.device == "cpu" else "cuda")
    if mesh.device.type == "cuda" and mesh.world > 1:
        # one nvcc per kernel source on rank 0; the others load its builds
        from ..ops import _build
        from ..parallel.mesh import barrier

        if mesh.is_main:
            _build.build_libraries()
        barrier(mesh)
    return mesh
