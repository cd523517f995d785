"""What the kernel ablation scripts (``*_ablation.py``) share: copies of one
CUDA source with textual changes, built at once with the port's ``nvcc``
flags and loaded; their times on the card, taken in turns; the card's SM
clock and power while they run; and the card's ``nvidia-smi`` name and
power limit.

A script gives its table of copies, ``ABLATIONS`` (name -> a list of
``(old, new)`` substitutions, each ``old`` replaced wherever it stands),
the source it changes (``SRC``, relative to the root of a checkout), its
inputs and its calls::

    texts = ablation_kit.sources(SRC, ABLATIONS, parent=args.parent)
    built = ablation_kit.build("ssd_ablation", texts)  # name -> (CDLL, log)
    ms = ablation_kit.in_turns(calls, reps=20, warmup=3)

``tests/test_torch_ablations.py`` checks on the CPU that every script's
table still applies to its source.  Nothing here imports ``torch`` or the
port when the module is imported.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def patched(text: str, subs, name: str, once: bool = False) -> str:
    """``text`` with each ``(old, new)`` of ``subs`` made in order; raises
    if an ``old`` is not there (or, with ``once``, not there exactly
    once), so that a table that no longer fits its source fails loudly."""
    for old, new in subs:
        n = text.count(old)
        if n == 0 or (once and n != 1):
            raise RuntimeError(f"{name}: the source does not hold "
                               f"{old[:60]!r}{' once' if once else ''}")
        text = text.replace(old, new)
    return text


def sources(src, ablations, *, parent=None, only=(), once=False):
    """name -> the text of each copy of ``src`` (a path relative to the
    root of a checkout): every entry of ``ablations`` (those in ``only``
    where it is not empty) with its substitutions made, and with
    ``parent`` (the root of another checkout) that checkout's ``src`` as
    ``"parent"``."""
    text = (ROOT / src).read_text()
    out = {name: patched(text, subs, name, once)
           for name, subs in ablations.items() if not only or name in only}
    if parent is not None:
        out["parent"] = (Path(parent) / src).read_text()
    return out


def build(out_name: str, texts):
    """Every copy of ``texts`` (name -> CUDA source) compiled at once, one
    ``nvcc`` each with the port's flags, into ``build/<out_name>/``;
    name -> (loaded library, ``nvcc``'s log with ptxas's lines)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kernels_build
    out_dir = ROOT / "build" / out_name
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels_build.find_nvcc(), *kernels_build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        built[name] = (ctypes.CDLL(str(out_dir / f"{name}.so")), log)
    return built


def entry_ptxas(log: str, entries) -> list[str]:
    """The four lines of ptxas's report from each entry function whose
    name holds one of ``entries``."""
    lines = log.splitlines()
    out = []
    for n, ln in enumerate(lines):
        if "Compiling entry function" in ln and any(e in ln
                                                    for e in entries):
            out += [s.strip() for s in lines[n:n + 4]]
    return out


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after ``warmup``,
    between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def in_turns(calls, reps: int = 10, warmup: int = 2, turns: int = 3):
    """name -> its ms in each turn, for ``calls`` (name -> a call) timed
    in turns: all of them, then all in reverse, then all again."""
    ms = {name: [] for name in calls}
    for turn in range(turns):
        names = list(calls) if turn % 2 == 0 else list(calls)[::-1]
        for name in names:
            ms[name].append(time_ms(calls[name], reps, warmup))
    return ms


class ClockSampler:
    """``nvidia-smi``'s SM clock (MHz) and power draw (W), sampled every
    0.2 s from a thread between ``start()`` and ``stop()``."""

    def __init__(self):
        self.samples, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(0.2):
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True).stdout.split(",")
            self.samples.append((float(out[0]), float(out[1])))

    def start(self):
        self._thread.start()

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join()
        mhz = [c for c, _ in self.samples]
        watts = [w for _, w in self.samples]
        return {"sm_mhz": [min(mhz), max(mhz)] if mhz else None,
                "power_w": [min(watts), max(watts)] if watts else None,
                "samples": len(self.samples)}


def smi() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
