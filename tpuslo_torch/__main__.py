"""Dispatcher for the port's binaries: ``python -m tpuslo_torch <name>``
(the counterpart of ``python -m tpuslo <name>``; only the ported
binaries are listed)."""

from __future__ import annotations

import importlib
import os
import sys

BINARIES = {
    "frontdoor": "tpuslo_torch.cli.frontdoor",
    "loadgen": "tpuslo_torch.cli.loadgen",
    "train": "tpuslo_torch.cli.train",
}

def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        names = "\n  ".join(sorted(BINARIES))
        print(f"usage: python -m tpuslo_torch <binary> [flags]\n\nbinaries:\n  {names}")
        return 0 if argv else 2
    name, rest = argv[0], argv[1:]
    module_path = BINARIES.get(name)
    if module_path is None:
        print(f"tpuslo_torch: binary {name!r} not ported yet", file=sys.stderr)
        return 2
    module = importlib.import_module(module_path)
    try:
        return module.main(rest)
    except BrokenPipeError:
        # Downstream pipe closed early (e.g. `| head`).  Suppress the
        # traceback and detach stdout so the exit-time flush doesn't
        # raise again, but exit 141 (128+SIGPIPE) rather than 0: output
        # may be truncated, and in a `cmd | head` pipeline the shell
        # takes the pipeline status from `head` anyway.
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        try:
            print(f"tpuslo_torch {name}: broken pipe, output truncated", file=sys.stderr)
        except BrokenPipeError:
            # `2>&1 | head`: stderr shares the dead pipe.
            os.dup2(devnull, sys.stderr.fileno())
        return 141


if __name__ == "__main__":
    raise SystemExit(main())
