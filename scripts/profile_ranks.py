#!/usr/bin/env python3
"""Profile the host side of one multi-rank phase of ``chip_smoke.py``.

Runs the kernel build, then the phase's rank processes on the card (as the
script does) with each rank's function under ``cProfile``, and writes, per
rank, the 45 functions with the most cumulative time and the 40 with the most
own time to ``<out>/profile_<phase>_rank<r>.txt``. The ranks' results are
held to the phase's checks as in ``chip_smoke.py``.

    python3 scripts/profile_ranks.py cp [--out build/profiles]

Phases: tp, cp, ep, pp, grid. Needs the card (the kernels build with nvcc).
"""

import argparse
import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

PHASES = {"tp": ("tp_rank", "TP_RANKS", "tp_report"),
          "cp": ("cp_rank", "CP_RANKS", "cp_report"),
          "ep": ("ep_rank", "EP_RANKS", "ep_report"),
          "pp": ("pp_rank", "PP_RANKS", "pp_report"),
          "grid": ("grid_rank", "GRID_RANKS", "grid_report")}


def profiled_rank(phase, out, rank, init_method, out_dir):
    """One rank of ``phase`` under cProfile; the two tables to ``out``."""
    target = getattr(cs, PHASES[phase][0])
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    target(rank, init_method, out_dir)
    prof.disable()
    text = [f"{phase} rank {rank}: {time.perf_counter() - t0:.1f} s\n"]
    for key, n in (("cumulative", 45), ("tottime", 40)):
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(n)
        text.append(buf.getvalue())
    (Path(out) / f"profile_{phase}_rank{rank}.txt").write_text("\n".join(text))


class _Rank:
    """A picklable ``target(rank, init_method, out_dir)`` for the spawn."""

    def __init__(self, phase, out):
        self.phase, self.out = phase, out

    def __call__(self, rank, init_method, out_dir):
        profiled_rank(self.phase, self.out, rank, init_method, out_dir)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phase", choices=sorted(PHASES))
    parser.add_argument("--out", default=str(ROOT / "build" / "profiles"))
    args = parser.parse_args()
    Path(args.out).mkdir(parents=True, exist_ok=True)
    cs.phase_device()
    from repro_torch.core import resolve_device
    resolve_device()
    cs.timed("build", cs.phase_build)
    _, n, report = PHASES[args.phase]
    with cs.spawned_ranks(_Rank(args.phase, args.out), getattr(cs, n), args.phase,
                          timeout=900) as (_, ranks, seconds):
        getattr(cs, report)(ranks)
    cs.log(f"{args.phase} ranks: {seconds:.1f} s; profiles in {args.out}")


if __name__ == "__main__":
    main()
