"""``python -m tpuslo_torch train``: deterministic demo training with
checkpoint/resume (the port of ``tpuslo/cli/train.py``).

The same flags and JSON lines as ``python -m tpuslo train``: one
``{"step", "loss"}`` line per step, then one ``{"done", "model", "mesh",
"first_step", "last_step", "final_loss"}`` line.  It trains on the card;
``--cpu-mesh 1`` trains on the CPU.  A plan of more than one device
(``--cpu-mesh N`` with N > 1, ``--slices`` > 1) is refused: the shardings
belong to the multi-device slice's last part (ROADMAP item 13b-iii).  ``mixtral_*``
trains the MoE family on the one device (dp 1, ep 1).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpuslo_torch train",
        description="deterministic demo training with checkpoint/resume",
    )
    parser.add_argument(
        "--model",
        choices=("llama_tiny", "llama32_1b", "llama32_3b", "mixtral_tiny", "mixtral_2b6"),
        default="llama_tiny",
        help="mixtral_* trains the MoE family (one device: dp 1, ep 1)",
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
        help="multi-slice plan (more than 1 needs the multi-device slice, ROADMAP 13b-iii)",
    )
    parser.add_argument(
        "--cpu-mesh", type=int, default=0, metavar="N",
        help="train on the CPU (N must be 1: more devices need ROADMAP 13b-iii)",
    )
    args = parser.parse_args(argv)
    if args.cpu_mesh > 1 or args.slices > 1:
        print(
            "tpuslo_torch train: a plan of more than one device (--cpu-mesh > 1, "
            "--slices > 1) belongs to the multi-device slice (ROADMAP item 13b-iii) and "
            "is not ported yet",
            file=sys.stderr,
        )
        return 2

    from tpuslo_torch.models.trainer import TrainerConfig, train
    from tpuslo_torch.parallel.mesh import make_mesh, plan_for_devices

    plan = plan_for_devices(1, slices=args.slices)
    try:
        mesh = make_mesh(plan, devices=["cpu"] if args.cpu_mesh else None)
    except RuntimeError as exc:
        print(f"tpuslo_torch train: {exc}", file=sys.stderr)
        return 2

    step_builder = None
    if args.model.startswith("mixtral"):
        from tpuslo_torch.models import mixtral

        cfg = getattr(mixtral, args.model)(max_seq_len=max(args.seq_len, 64))
        mesh_summary = {"dp": 1, "ep": 1}
        step_builder = mixtral.build_moe_train_step
    else:
        from tpuslo_torch.models import llama

        cfg = getattr(llama, args.model)(max_seq_len=max(args.seq_len, 64))
        mesh_summary = {"dcn": plan.dcn, "dp": plan.dp, "fsdp": plan.fsdp, "tp": plan.tp}

    if args.corpus:
        with open(args.corpus, encoding="utf-8") as fh:
            texts = [line.rstrip("\n") for line in fh if line.strip()]
    else:
        texts = [
            f"synthetic document {i}: the five boxing wizards jump quickly"
            for i in range(200)
        ]

    tcfg = TrainerConfig(
        steps=args.steps,
        batch=args.batch,
        seq_len=args.seq_len,
        seed=args.seed,
        ckpt_every=args.ckpt_every,
    )
    result = train(
        cfg, mesh, texts, tcfg,
        checkpoint_dir=args.checkpoint_dir or None,
        step_builder=step_builder,
    )
    for i, loss in enumerate(result["losses"]):
        print(json.dumps({"step": result["first_step"] + i + 1, "loss": round(loss, 6)}))
    print(
        json.dumps(
            {
                "done": True,
                "model": args.model,
                "mesh": mesh_summary,
                "first_step": result["first_step"],
                "last_step": result["last_step"],
                "final_loss": round(result["losses"][-1], 6) if result["losses"] else None,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
