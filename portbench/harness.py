"""The benchmark's driver: finds a cell's parts by name, sets it up, runs its
closed-loop window, checks what the window produced and builds the result.

Everything that belongs to one configuration, cell, operation or metric sits
in a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json`` (the manifest's ``file``): the deployment, the
  code, the block size, the guarantees; its ``reference`` names
  ``reference/<reference>.py``, the plain reference;
- ``workloads/<cell>.json``: the cell's operation and traffic parameters;
  its ``op`` names ``traffic/<op>.py``, the traffic driver;
- ``metrics/<metric>.py``: one reader per metric, ``read(run) -> float |
  None``.

A cell runs on its ``chips`` cards, ``cuda:0`` … ``cuda:{chips-1}``: each is
synchronised after every call, a call is timed on the first card's clock to
the end of the work on every card (``joiner``), and the peak is the fullest
card's.

The program under test is ``repro_torch``, imported from the checkout's
``src/``. Nothing here imports JAX or the JAX package (``repro``).
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import random
import re
import subprocess
import sys
import time
import warnings
from contextlib import nullcontext
from pathlib import Path

import torch

from portbench import driver as driver_lib
from portbench import tracing, work

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level module names
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# the profiler says so each time the traced stretch starts after the warm one
warnings.filterwarnings("ignore", message="Warning: Profiler clears events")


class SetupError(RuntimeError):
    """The cell cannot run here: no card, too few cards, a name not found."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """``portbench/<folder>/<name>.py`` as a module, found by name."""
    if not _NAME.match(name):
        raise SetupError(f"bad name {name!r}")
    path = BENCH / folder / f"{name}.py"
    if not path.exists():
        raise SetupError(f"no {folder} module named {name!r} ({path.relative_to(ROOT)})")
    mod_name = f"portbench.{folder}." + re.sub(r"[.-]", "_", name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def import_program():
    """``repro_torch`` from this checkout's ``src/``, and nowhere else."""
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise SetupError(f"the program is not in this checkout ({src / 'repro_torch'})")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch
    where = Path(repro_torch.__file__).resolve()
    if src.resolve() not in where.parents:
        raise SetupError(f"repro_torch was imported from {where}, not from {src}")
    return repro_torch


class Spec:
    """A cell as the manifest and its files describe it."""

    def __init__(self, name: str, overrides: dict | None = None):
        manifest = load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SetupError(f"no workload named {name!r} in BENCHMARK.json")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in manifest["configs"]}
        self.cfg = load_json(ROOT / configs[self.entry["config"]]["file"])
        if not _NAME.match(name):
            raise SetupError(f"bad name {name!r}")
        self.params = load_json(BENCH / "workloads" / f"{name}.json")
        for key in ("config", "traffic"):
            if self.params[key] != self.entry[key]:
                raise SetupError(f"workloads/{name}.json has {key} {self.params[key]!r}, "
                                 f"the manifest {self.entry[key]!r}")
        overrides = overrides or {}
        self.cfg.update({k: v for k, v in overrides.items() if k in self.cfg})
        self.params.update({k: v for k, v in overrides.items() if k in self.params})
        self.chips = int(self.entry["chips"])
        self.metrics = {}          # name -> manifest entry, for this cell
        for kind in ("end_to_end", "per_layer"):
            self.metrics[kind] = [m for m in manifest[kind]
                                  if name in m.get("workloads", [name])]

    def traffic(self):
        """The cell's traffic module, ``traffic/<op>.py``."""
        return load_module("traffic", self.params["op"])


class Run:
    """What a window produced, as the metric readers see it."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.calls = 0
        self.call_ms: list[float] = []       # each call, on the device's clock (CUDA events)
        self.dispatch_ms: list[float] = []   # each untraced call's entry, on the host clock
        self.useful_bytes = 0                # a call's bytes asked for
        self.needed_bytes = 0                # a call's bytes the result needs
        self.device_name = ""
        self.trace: dict | None = None


class Reservoir:
    """A uniform sample of ``size`` calls' answers over the whole window,
    drawn from the seed as the calls come (Algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, random.Random(f"portbench-check:{seed}")
        self.kept: list[tuple[int, torch.Tensor]] = []

    def offer(self, i: int, out: torch.Tensor) -> None:
        if len(self.kept) < self.size:
            self.kept.append((i, out))
            return
        j = self.rng.randrange(i + 1)
        if j < self.size:
            self.kept[j] = (i, out)


def span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else nullcontext()


def sync(devices) -> None:
    """Waits for every card of ``devices`` (one device, or a list)."""
    for d in driver_lib.cards(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def joiner(devices):
    """For a cell of several cards, a function that makes the first card's
    current stream wait for what is queued so far on every other card's
    current stream; None for one card. Called after a call returns and
    before the event that ends its time, so that ``call_ms`` runs to the
    end of every card's work."""
    devices = driver_lib.cards(devices)
    if len(devices) < 2 or devices[0].type != "cuda":
        return None
    first = devices[0]
    marks = [(d, torch.cuda.Event()) for d in devices[1:]]

    def join() -> None:
        stream = torch.cuda.current_stream(first)
        for d, mark in marks:
            mark.record(torch.cuda.current_stream(d))
            stream.wait_event(mark)
    return join


def prepare(spec: Spec, seed: int, devices):
    """The cell's traffic driver, found by its ``op``, with its pool laid out
    on ``devices`` (one device, or the cell's cards)."""
    reference = load_module("reference", spec.cfg["reference"])
    return spec.traffic().prepare(driver_lib.Cell(spec.cfg, spec.params, seed, devices,
                                                  reference))


def warm_up(drv, devices, hold: int, trace: bool) -> None:
    """Every shape the window uses, once: the program built, its kernels
    compiled and ``hold + 1`` answers held at once, so the allocator holds
    the blocks that the window's sample keeps; the profiler started once,
    so its start-up is not paid inside the window."""
    outs = []
    for i in range(hold + 1):
        outs.append(drv.call(i))
        sync(devices)
    del outs
    if trace:
        with tracing.profiler():
            drv.call(0)
            sync(devices)
    sync(devices)


def window(devices, seconds: float, call, sample: Reservoir,
           stretch: tracing.Stretch | None, run: Run) -> list[str]:
    """The closed loop: one caller, each call followed by a synchronise of
    every card, until ``seconds`` have passed. Returns the errors of calls
    that raised. A call's time runs on the first card's clock, from an event
    recorded before the call to one recorded after its return and, on
    several cards, after the first card's stream has joined every other's."""
    cuda = driver_lib.cards(devices)[0].type == "cuda"
    join = joiner(devices)
    errors: list[str] = []
    t0 = time.perf_counter()
    i = 0
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
        traced = stretch.tick(elapsed) if stretch is not None else False
        with span("portbench.call", traced):
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            h0 = time.perf_counter()
            try:
                with span("portbench.entry", traced):
                    out = call(i)
            except Exception as exc:  # a failed call counts, and ends the window
                errors.append(f"call {i}: {type(exc).__name__}: {exc}")
                break
            h1 = time.perf_counter()
            if join is not None:
                join()
            if cuda:
                e1.record()
            with span("portbench.sync", traced):
                sync(devices)
            h2 = time.perf_counter()
        run.call_ms.append(e0.elapsed_time(e1) if cuda else (h2 - h0) * 1e3)
        if not traced:
            run.dispatch_ms.append((h1 - h0) * 1e3)
        sample.offer(i, out)
        del out
        i += 1
    run.window_s = time.perf_counter() - t0
    run.calls = i
    return errors


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20)
        return p.stdout.strip().splitlines()[0] if p.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def run_cell(cell: str | Spec, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: torch.device, mode: str = "program",
             overrides: dict | None = None) -> dict:
    """One run of a cell (its name in the manifest, or a ``Spec``): set-up,
    the window, the check, the metrics. On a card the cell runs on
    ``cuda:0`` … ``cuda:{chips-1}`` (``device`` is ``cuda:0``); on the CPU
    (the CPU tests) on ``device`` alone.

    ``mode="control"`` puts the plain reference, in the narrower field, in
    the program's place (the control of ``correct``; the benchmark's own
    runs never do). Returns the result's fields and, under ``"notes"``, the
    lines for standard error."""
    spec = cell if isinstance(cell, Spec) else Spec(cell, overrides)
    name = spec.name
    devices = ([torch.device("cuda", c) for c in range(spec.chips)]
               if device.type == "cuda" else [device])
    import_program()
    from repro_torch.core import jitcache
    from repro_torch.kernels.gf_encode import kernel

    marks = {"imports": time.perf_counter() - t_start}
    drv = prepare(spec, seed, devices)
    sync(devices)
    marks["inputs"] = time.perf_counter() - t_start
    call = drv.call if mode == "program" else drv.control
    hold = int(spec.params["check_calls"])
    if mode == "program":
        warm_up(drv, devices, hold, trace)
    marks["warm"] = time.perf_counter() - t_start
    sync(devices)
    gc.collect()

    run = Run()
    run.useful_bytes = drv.useful_blocks * work.block_bytes(spec.cfg)
    run.needed_bytes = drv.needed_blocks * work.block_bytes(spec.cfg)
    run.device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run.setup_s = time.perf_counter() - t_start

    built0, counts0 = jitcache.stats()["misses"], kernel.launch_counts()
    sample = Reservoir(hold, seed)
    stretch = tracing.Stretch(seconds, len(devices)) if trace else None
    errors = window(devices, seconds, call, sample, stretch, run)
    built, counts = jitcache.stats()["misses"] - built0, kernel.launch_counts()
    if stretch is not None:
        run.trace = stretch.summary()
    card_peaks = [torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0
                  for d in devices]

    programs = jitcache.stats()
    # the program's state goes before the reference runs
    jitcache.clear()
    gc.collect()
    t_check = time.perf_counter()
    wrong = words = wrong_calls = 0
    for i, out in sample.kept:
        w, n = drv.check(i, out)
        wrong, words, wrong_calls = wrong + w, words + n, wrong_calls + (w > 0)
    check_s = time.perf_counter() - t_check
    checked = len(sample.kept)
    sample.kept.clear()
    del drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = {"wrong_words": {"value": wrong, "limit": 0},
              "failed_calls": {"value": len(errors), "limit": 0}}
    correct = run.calls > 0 and words > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in spec.metrics["per_layer" if trace else "end_to_end"]:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.device_name, "count": spec.chips,
           "memory_peak_bytes": int(max(card_peaks))}
    result = {"correct": bool(correct), "attempted": run.calls + len(errors),
              "failed": len(errors) + wrong_calls, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace["busy_s"], run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    result["checks"] = checks
    per_call = {k: (counts[k] - counts0[k]) / max(run.calls, 1) for k in counts}
    notes = errors + [
        f"portbench: cell={name} mode={mode} seed={seed} calls={run.calls} "
        f"window_s={run.window_s!r} setup_s={run.setup_s!r} check_s={check_s!r} "
        f"calls_checked={checked} words_checked={words} "
        f"setup_marks_s={','.join(f'{k}:{v:.3f}' for k, v in marks.items())}",
        f"portbench: programs built in the window={built} "
        f"wrapper launches per call={per_call} jitcache={programs}",
        f"portbench: memory peak by card={dict(zip(map(str, devices), card_peaks))}",
    ]
    result["notes"] = notes
    return result


def report(result: dict) -> int:
    """Prints a run's notes to standard error and its result line to standard
    output; returns the exit code. The look for JAX and the JAX package comes
    last, once the check and every metric reader have run, so that nothing
    any of them loaded goes unseen; where it finds one, no result is printed."""
    print(f"portbench: card {card_line()}", file=sys.stderr)
    for line in result.pop("notes"):
        print(line, file=sys.stderr)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: refusing to report: {loaded} loaded in this process",
              file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = Spec(args.workload)
        if not torch.cuda.is_available():
            raise SetupError("no CUDA device: the benchmark measures only on a card")
        if torch.cuda.device_count() < spec.chips:
            raise SetupError(f"the cell needs {spec.chips} cards, "
                             f"{torch.cuda.device_count()} are visible")
        torch.set_num_threads(1)
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start, device=torch.device("cuda", 0))
    except SetupError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    return report(result)
