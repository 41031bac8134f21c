"""``python -m tpuslo_torch train``: deterministic demo training with
checkpoint/resume (the port of ``tpuslo/cli/train.py``).

The same flags and JSON lines as ``python -m tpuslo train``: one
``{"step", "loss"}`` line per step, then one ``{"done", "model", "mesh",
"first_step", "last_step", "final_loss"}`` line.  It trains over every
visible card (one NCCL rank each) or, with ``--cpu-mesh N``, over N gloo
ranks on the CPU; N devices factor as JAX's do
(:func:`~tpuslo_torch.parallel.mesh.plan_for_devices`, with a dcn axis of
``--slices`` slices).  ``mixtral_*`` trains the MoE family over a
``(dp, ep)`` mesh, ``ep = gcd(N, n_experts)``.  Every rank trains; rank 0's
losses are printed (every rank holds the same ones).  Without a card and
without ``--cpu-mesh`` it exits 2.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def _mesh(args, n: int, device: str):
    """(mesh, its summary, the step builder, the config) of one rank."""
    from tpuslo_torch.parallel.mesh import dp_ep_mesh, make_mesh, plan_for_devices

    devices = [device] if device == "cpu" else None
    if args.model.startswith("mixtral"):
        from tpuslo_torch.models import mixtral

        cfg = getattr(mixtral, args.model)(max_seq_len=max(args.seq_len, 64))
        ep = math.gcd(n, cfg.n_experts)
        dp = n // ep
        if n == 1:
            mesh = make_mesh(plan_for_devices(1), devices=devices)
        else:
            mesh = dp_ep_mesh(dp, ep, devices=devices)
        return mesh, {"dp": dp, "ep": ep}, mixtral.build_moe_train_step, cfg
    from tpuslo_torch.models import llama

    cfg = getattr(llama, args.model)(max_seq_len=max(args.seq_len, 64))
    plan = plan_for_devices(n, slices=args.slices)
    summary = {"dcn": plan.dcn, "dp": plan.dp, "fsdp": plan.fsdp, "tp": plan.tp}
    return make_mesh(plan, devices=devices), summary, None, cfg


def _texts(args) -> list[str]:
    if args.corpus:
        with open(args.corpus, encoding="utf-8") as fh:
            return [line.rstrip("\n") for line in fh if line.strip()]
    return [f"synthetic document {i}: the five boxing wizards jump quickly" for i in range(200)]


def _session(args, n: int, device: str) -> dict:
    """One rank's training session: the trainer's result and the mesh's
    summary."""
    from tpuslo_torch.models.trainer import TrainerConfig, train

    mesh, summary, step_builder, cfg = _mesh(args, n, device)
    tcfg = TrainerConfig(
        steps=args.steps,
        batch=args.batch,
        seq_len=args.seq_len,
        seed=args.seed,
        ckpt_every=args.ckpt_every,
    )
    result = train(cfg, mesh, _texts(args), tcfg,
                   checkpoint_dir=args.checkpoint_dir or None, step_builder=step_builder)
    return {**result, "mesh": summary}


def rank_session(rank: int, world: int, args, device: str) -> dict:
    """A spawned rank's session (``run_ranks``' function).  CPU ranks share
    the host's cores, each taking its share of them for its threads."""
    if device == "cpu":
        import os

        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    return _session(args, world, device)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpuslo_torch train",
        description="deterministic demo training with checkpoint/resume",
    )
    parser.add_argument(
        "--model",
        choices=("llama_tiny", "llama32_1b", "llama32_3b", "mixtral_tiny", "mixtral_2b6"),
        default="llama_tiny",
        help="mixtral_* trains the MoE family over a dp x ep mesh (experts sharded)",
    )
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--corpus", help="text file, one document per line")
    parser.add_argument("--checkpoint-dir", default="")
    parser.add_argument("--ckpt-every", type=int, default=0)
    parser.add_argument(
        "--slices", type=int, default=1,
        help="multi-slice plan: factor a dcn data-parallel axis out first "
        "(the cross-slice gradient all_reduce is the only dcn collective)",
    )
    parser.add_argument(
        "--cpu-mesh", type=int, default=0, metavar="N",
        help="train over N gloo ranks on the CPU instead of the cards",
    )
    args = parser.parse_args(argv)
    if args.model.startswith("mixtral") and args.slices > 1:
        parser.error("--slices applies to the llama dp/fsdp/tp plan")

    import torch

    from tpuslo_torch.parallel.mesh import plan_for_devices, run_ranks

    if args.cpu_mesh:
        n, device, backend = args.cpu_mesh, "cpu", "gloo"
    else:
        n, device, backend = torch.cuda.device_count(), "cuda", "nccl"
        if n == 0:
            print("tpuslo_torch train: no CUDA device is available; pass --cpu-mesh N to "
                  "train on the CPU", file=sys.stderr)
            return 2
    try:
        plan_for_devices(n, slices=args.slices)
    except ValueError as exc:
        print(f"tpuslo_torch train: {exc}", file=sys.stderr)
        return 2
    if n == 1:
        result = _session(args, 1, device)
    else:
        result = run_ranks(rank_session, n, backend, device, timeout_s=24 * 3600.0,
                           args=(args, device))[0]

    for i, loss in enumerate(result["losses"]):
        print(json.dumps({"step": result["first_step"] + i + 1, "loss": round(loss, 6)}))
    print(
        json.dumps(
            {
                "done": True,
                "model": args.model,
                "mesh": result["mesh"],
                "first_step": result["first_step"],
                "last_step": result["last_step"],
                "final_loss": round(result["losses"][-1], 6) if result["losses"] else None,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
