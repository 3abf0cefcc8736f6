"""``python -m rnnwavefunctions <command> ...`` — subcommand dispatcher.

The ``[project.scripts]`` console entries (``run-1dtfim`` etc.) only exist
after a ``pip install``; an in-tree checkout reaches the same mains here
without one.  Mirrors the reference's four runner scripts
(``/root/reference/1DTFIM/run_1dTFIM.py:9``,
``2DTFIM_1DRNN/run_2dTFIM.py:10``, ``2DTFIM_2DRNN/run_2dTFIM.py:10``,
``J1J2/run_j1j2.py:11``) plus the evaluation CLI.

Dispatch imports the command modules lazily: listing commands or printing
usage never initializes a JAX backend or touches a device.  (Running via
``python -m`` still executes the package ``__init__``, which imports jax
and the model modules — what is avoided is backend/device initialization,
not the import cost.)
"""
from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "1dtfim": ("rnnwavefunctions.cli.run_1dtfim",
               "train a 1D pRNN on the 1D TFIM (reference run_1dTFIM)"),
    "2dtfim-1drnn": ("rnnwavefunctions.cli.run_2dtfim_1drnn",
                     "train a snake-order 1D pRNN on the 2D TFIM"),
    "2dtfim-2drnn": ("rnnwavefunctions.cli.run_2dtfim_2drnn",
                     "train a 2D MDRNN wavefunction on the 2D TFIM"),
    "j1j2": ("rnnwavefunctions.cli.run_j1j2",
             "train a complex U(1) cRNN on the J1-J2 chain"),
    "evaluate": ("rnnwavefunctions.cli.evaluate",
                 "measure a checkpoint: energy, observables, fidelity"),
}


def _usage() -> str:
    lines = ["usage: python -m rnnwavefunctions <command> [args...]", "",
             "commands:"]
    for name, (_, doc) in COMMANDS.items():
        lines.append(f"  {name:<14} {doc}")
    lines.append("")
    lines.append("run `python -m rnnwavefunctions <command> --help` "
                 "for per-command flags")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    module = importlib.import_module(COMMANDS[cmd][0])
    # argparse derives prog from sys.argv[0]; show the real invocation
    # in per-command --help instead of ".../__main__.py".  Restored after
    # the command returns — in-process callers (the test suite) must not
    # see a rewritten argv[0] leak past the dispatch.
    saved_argv0 = sys.argv[0]
    sys.argv[0] = f"python -m rnnwavefunctions {cmd}"
    try:
        # Runner mains return their result objects (the training runners
        # return a (mean_series, var_series) tuple for in-process callers,
        # run_loop.py) — only an explicit int is an exit STATUS.  Anything
        # else is success: returning the tuple here would make
        # sys.exit(main()) print it to stderr and exit 1 on every
        # successful training run.
        out = module.main(rest)
        return out if isinstance(out, int) else 0
    finally:
        sys.argv[0] = saved_argv0


if __name__ == "__main__":
    sys.exit(main())
