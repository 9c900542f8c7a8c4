"""One run of one cell: set-up, the measured window, the check of what the
window served, and the result line's numbers.

The system under test is the port's front door, driven as a client would:

  ServeConfig(backend="cluster", disaggregated=True, paged=True,
              transport="fused", ...)  -> build_system -> submit / step

Set-up (``setup_s``: from the process's start to the window's first round)
makes the weights and adapters on the card from the seed, builds the
system, and runs a warm-up wave that brings every adapter onto the card
and captures each decode bucket the cell's traffic uses. The requests due
at or before the window's opening (a backlog: all of them) are then
submitted, and the round that admits them runs.

The window is timed on the host clock, the harness's own: each request
is due at a time of the generator's schedule and is submitted on the
first round boundary at or after it (with ``arrival=system.now``, so the
virtual-clock cluster enqueues it at once); each event that ``step()``
returns is stamped when ``step()`` returns, after the round's tokens were
read back from the card. The program's virtual TTFT and TPOT are not
read.

Then the peak memory is read, the program's state is freed, and a
sample of the finished requests is held against the plain reference
(``correct.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import pathlib
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from bench import correct, devtrace, workload
from bench.weights import make_adapters, make_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG_DIR = ROOT / "bench" / "configs"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SAMPLE = 6              # finished requests held against the reference
MIN_TOKENS = 200        # served tokens the check needs at the least

# the published config.json keys the port's ModelConfig reads
HF_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
           "num_attention_heads": "n_heads",
           "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
           "vocab_size": "vocab_size", "num_experts_per_tok": "top_k",
           "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps"}

# the system under test: the disaggregated plane of the cluster backend,
# paged, with the fused transport; a traffic file's ``serve`` block may
# set any other ServeConfig field, and these too
SERVE_FIXED = {"backend": "cluster", "disaggregated": True, "paged": True,
               "transport": "fused", "n_instances": 1,
               "server_replicas": 1}
# keys of the ``serve`` block that the harness reads itself
SERVE_OWN = ("slots", "warm_buckets", "warm_prompt")


class CellError(RuntimeError):
    """A cell that cannot run as its files describe it."""


def clock() -> float:
    return time.perf_counter()


# ------------------------------ the files ------------------------------ #
def load_benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise CellError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_config(name: str) -> Dict:
    path = CONFIG_DIR / f"{name}.json"
    if not path.is_file():
        raise CellError(f"no configuration file {path}")
    return json.loads(path.read_text())


def model_fields(conf: Dict) -> Dict:
    """The port's ``ModelConfig`` fields of a configuration file, read
    from its config.json keys as run."""
    f = {port: conf[hf] for hf, port in HF_KEYS.items() if hf in conf}
    f["n_experts"] = conf.get("num_experts", conf.get("num_local_experts"))
    f["d_ff"] = conf.get("moe_intermediate_size",
                         conf.get("intermediate_size"))
    f.setdefault("head_dim", conf["hidden_size"]
                 // conf["num_attention_heads"])
    f["qkv_bias"] = bool(conf.get("attention_bias", False))
    f["tie_embeddings"] = bool(conf.get("tie_word_embeddings", False))
    f["sliding_window"] = int(conf.get("sliding_window") or 0)
    f["dtype"] = conf.get("torch_dtype", "bfloat16")
    f["rope_theta"] = float(f["rope_theta"])
    f["norm_eps"] = float(f["norm_eps"])
    return f


def port_config(conf: Dict, override: Optional[Dict] = None):
    from repro_torch.configs.base import ModelConfig
    f = model_fields(conf)
    f.update(override or {})
    ad = conf["adapters"]
    return ModelConfig(name=conf["name"], family="moe",
                       lora_rank=int(ad["pool_rank"]),
                       lora_targets=("gate", "up", "down"), **f)


def serve_config(serve: Dict, n_adapters: int, trace: bool):
    """The ServeConfig of a traffic file's ``serve`` block: ``slots`` is
    the batch; every adapter has a slot on the card unless the block sets
    ``adapter_cache_slots``; any other ServeConfig field it names
    (``page_size``, ``max_len``, ``prefill_chunk``, ``mesh_shape``, ...)
    is passed on, a list as a tuple."""
    from repro_torch.serving.api import ServeConfig
    fields = {f.name for f in dataclasses.fields(ServeConfig)}
    kw = dict(SERVE_FIXED, max_batch=int(serve["slots"]),
              adapter_cache_slots=n_adapters, trace=trace)
    for key, value in serve.items():
        if key in SERVE_OWN:
            continue
        if key not in fields:
            raise CellError(f"serve key {key!r} is no ServeConfig field")
        kw[key] = tuple(value) if isinstance(value, list) else value
    return ServeConfig(**kw)


def sizes(cfg, lora_scale: float) -> Dict:
    """The plain numbers the reference and the flop count read."""
    keys = ("d_model", "n_heads", "n_kv_heads", "head_dim", "n_layers",
            "n_experts", "top_k", "rope_theta", "norm_eps", "d_ff",
            "vocab_size")
    out = {k: getattr(cfg, k) for k in keys}
    out["lora_scale"] = lora_scale
    return out


# ------------------------------ the run -------------------------------- #
class Run:
    """Everything a run records; the metric readers read it."""

    def __init__(self, cell: Dict, spec: Dict, seconds: float):
        self.cell = cell
        self.seconds = seconds
        # the suffix of the metric names this cell reports
        self.regime = spec["arrivals"]
        self.chips = int(cell["chips"])
        self.setup_s = float("nan")
        self.t_open = self.t_close = float("nan")
        self.rounds: List[Dict] = []    # window rounds, in order
        self.reqs: Dict[int, Dict] = {}
        self.lateness: List[float] = []  # submit time less due time, s
        self.devtrace: Optional[Dict] = None
        self.sizes: Dict = {}
        self.ranks: List[int] = []
        self.queue_ran_dry = False
        # seconds the profiler's start and stop took inside the window
        self.untimed_s = 0.0

    # window helpers for the readers
    def window_s(self) -> float:
        """The window's seconds, less what starting and stopping the
        profiler took in a traced run."""
        return self.t_close - self.t_open - self.untimed_s

    def due_in_window(self) -> List[Dict]:
        return [r for r in self.reqs.values()
                if self.t_open <= r["due_abs"] < self.t_open + self.seconds]


def _submit(system, run: Run, req: workload.Req, now: float,
            due_abs: float) -> None:
    from repro_torch.serving.api import RequestState
    h = system.submit(req.prompt.tolist(), req.adapter,
                      max_new_tokens=req.output_len, arrival=system.now)
    run.reqs[h.rid] = {
        "idx": req.idx, "adapter": req.adapter, "prompt": req.prompt,
        "output_len": req.output_len, "due_abs": due_abs,
        "submitted": now, "prefill": None, "stamps": [], "tokens": [],
        "finished": None,
        "rejected": h.state == RequestState.REJECTED}
    if due_abs >= run.t_open:
        run.lateness.append(now - due_abs)


def _stamp(run: Run, evs, t: float) -> int:
    """Stamp the round's events at ``t``; returns its token count."""
    n = 0
    for ev in evs:
        r = run.reqs.get(ev.rid)
        if r is None:
            continue
        if ev.kind == "prefill":
            r["prefill"] = t
        elif ev.kind == "token":
            r["stamps"].append(t)
            r["tokens"].append(int(ev.token))
            n += 1
        elif ev.kind == "finished":
            r["finished"] = t
    return n


def _decode_ms(system, n_before: int) -> Optional[float]:
    """The program's wall ms of the decode step the last ``step()`` ran
    (its ``decode.step`` span), or None (no tracer, or no decode)."""
    spans = getattr(system.tracer, "spans", None)
    if spans is None:
        return None
    ms = [s.args["wall_ms"] for s in spans[n_before:]
          if s.name == "decode.step" and s.args]
    return float(sum(ms)) if ms else None


def _rf(name: str, on: bool):
    """A harness span for the profiler, while it records."""
    if on:
        return torch.profiler.record_function(devtrace.SPAN_PREFIX + name)
    return contextlib.nullcontext()


def _profiler(dev):
    """A profiler of the host and, on a card, of the card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, acc_events=True)


def _wait_idle(system, limit: int = 10_000) -> None:
    for _ in range(limit):
        if system.backend.idle():
            return
        system.step()
    raise CellError("the warm-up wave did not drain")


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        start: float, *, device: Optional[str] = None,
        override: Optional[Dict] = None,
        spec_override: Optional[Dict] = None,
        fault: Optional[Callable] = None, control: bool = False) -> Dict:
    """One run of ``cell_name``. ``device`` None: the cell's cards (the
    caller has checked them). ``override`` / ``spec_override``: model
    fields and traffic parameters replaced (the CPU tests' small sizes);
    ``fault``: called with the built system before the window (the tests'
    planted faults); ``control``: also read the control (the reference in
    fp8) and the bf16 witness on the same sample, as ``control.py`` does.
    Returns the ``Run``, the result line's fields but ``device``, the
    numbers compared (``checks``), the peak memory, and the gaps, sample
    and control readings behind them."""
    from repro_torch.core.adapter import AdapterPool
    from repro_torch.serving.api import RequestState, build_system

    bench = load_benchmark()
    cell = find_cell(bench, cell_name)
    conf = load_config(cell["config"])
    spec = dict(workload.load_traffic(cell["traffic"]))
    spec.update(spec_override or {})
    run_ = Run(cell, spec, seconds)
    dev = torch.device(device or "cuda:0")
    cfg = port_config(conf, override)
    ad = conf["adapters"]
    n_ad, r_pool = int(ad["count"]), int(ad["pool_rank"])
    lora_scale = float(ad["alpha"]) / r_pool
    ranks = workload.adapter_ranks(n_ad, ad["rank_cycle"], seed)
    run_.ranks, run_.sizes = ranks, sizes(cfg, lora_scale)

    # ---- set-up: inputs from the seed, the system, the warm-up ---- #
    init = conf["init"]
    params = make_params(cfg, init, seed, dev)
    factors = make_adapters(cfg, ranks, r_pool, lora_scale,
                            float(init["lora_share"]), seed, dev)
    pool = AdapterPool(cfg, n_ad, r_pool, lora_scale, factors,
                       ranks=tuple(ranks))
    serve = spec["serve"]
    system = build_system(serve_config(serve, n_ad, trace), cfg,
                          params=params, pool=pool)
    wave = workload.warmup_wave(serve["warm_buckets"], n_ad,
                                cfg.vocab_size, int(serve["warm_prompt"]),
                                seed)
    for req in wave:
        system.submit(req.prompt.tolist(), req.adapter,
                      max_new_tokens=req.output_len)
    _wait_idle(system)
    reqs = workload.generate(spec, n_ad, cfg.vocab_size, seed, seconds)
    if fault is not None:
        fault(system)
    if trace:
        # the profiler's first start sets up the device tracing, which
        # takes seconds: done once here, in the set-up
        warm = _profiler(dev)
        warm.start()
        warm.stop()
        del warm
    # the requests due at the window's opening (a backlog's every one)
    # are queued in set-up, and the round that admits them runs
    pending = [req for req in reqs if req.due > 0]
    if len(pending) < len(reqs):
        now = clock()
        for req in reqs[:len(reqs) - len(pending)]:
            _submit(system, run_, req, now, -1.0)
        _stamp(run_, system.step(), clock())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run_.t_open = clock()
    run_.setup_s = run_.t_open - start

    # ---- the window ---- #
    t_end = run_.t_open + seconds
    # traced runs profile a steady stretch from a third of the window: its
    # length counts from when the profiler has started
    prof_t = (run_.t_open + seconds / 3.0, min(3.0, seconds / 3.0)) \
        if trace else None
    prof_decode: List[Optional[float]] = []
    tracing = [False]
    prof = None

    def queue_len() -> int:
        return system.backend.cluster.sched.queue_len()

    def one_round(t_stop: Optional[float]) -> bool:
        """Submit what is due, then step once (or sleep to the next
        arrival). False when nothing is left to do before ``t_stop``."""
        on = tracing[0]
        now = clock()
        with _rf("submit", on):
            while pending and run_.t_open + pending[0].due <= now:
                req = pending.pop(0)
                _submit(system, run_, req, now, run_.t_open + req.due)
        if system.backend.idle():
            if not pending:
                return False
            wake = run_.t_open + pending[0].due
            if t_stop is not None:
                wake = min(wake, t_stop)
            with _rf("sleep", on):
                time.sleep(max(0.0, wake - clock()))
            return True
        n_spans = len(getattr(system.tracer, "spans", ()))
        t0 = clock()
        with _rf("step", on):
            evs = system.step()
        t1 = clock()
        with _rf("harness", on):
            n_tok = _stamp(run_, evs, t1)
            dms = _decode_ms(system, n_spans)
            run_.rounds.append({"t0": t0, "t1": t1, "tokens": n_tok,
                                "decode_ms": dms, "queue": queue_len(),
                                "admitted": [ev.rid for ev in evs
                                             if ev.kind == "prefill"]})
            if on:
                prof_decode.append(dms)
        return True

    def loop(t_stop: float) -> bool:
        while clock() < t_stop:
            if not one_round(t_stop):
                return False
            if not queue_len():
                run_.queue_ran_dry = True
        return True

    going = True
    if prof_t is not None:
        going = loop(prof_t[0])
        if going:
            t0 = clock()
            prof = _profiler(dev)
            prof.start()
            tracing[0] = True
            run_.untimed_s += clock() - t0
            going = loop(min(clock() + prof_t[1], t_end))
            t0 = clock()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            prof.stop()
            tracing[0] = False
            run_.untimed_s += clock() - t0
    if going:
        loop(t_end)
    run_.t_close = clock()
    if prof is not None:
        run_.devtrace = devtrace.reduce(prof, prof_decode)
        del prof

    # ---- memory, then free the program's state ---- #
    peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for i in range(torch.cuda.device_count()):
            peak = max(peak, torch.cuda.max_memory_allocated(i))
    finished = [r for r in run_.reqs.values() if r["finished"] is not None]
    states = {rid: h.state for rid, h in system.handles.items()}
    system.close()
    del system, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check against the plain reference ---- #
    sample = correct.pick_sample(finished, seed, SAMPLE)
    gaps = correct.served_gaps(params, factors, run_.sizes, sample, ranks)
    checks = correct.checks(gaps, conf["correct"], MIN_TOKENS)
    ok = correct.passed(checks)
    ctl = {prec: correct.control_gaps(params, factors, run_.sizes, sample,
                                      ranks, prec)
           for prec in ("fp8", "bf16")} if control else None
    del params, factors
    gc.collect()

    due = {r["idx"] for r in run_.due_in_window()}
    failed = sum(1 for rid, r in run_.reqs.items()
                 if r["rejected"] or states.get(rid) == RequestState.REJECTED
                 or (r["idx"] in due and not r["stamps"]))
    # every request the window served a token of, or that fell due in it
    attempted = sum(1 for r in run_.reqs.values()
                    if r["idx"] in due or any(
                        run_.t_open <= t <= run_.t_close
                        for t in r["stamps"]))
    metrics = read_metrics(bench, cell_name, run_, trace)
    return {"run": run_, "correct": bool(ok), "attempted": attempted,
            "failed": failed, "metrics": metrics, "checks": checks,
            "memory_peak_bytes": peak, "gaps": gaps, "sample": sample,
            "control": ctl}


# ----------------------------- the metrics ----------------------------- #
def reader(name: str):
    """The reader of metric ``name``: ``bench/metrics/<base>.py`` for the
    part of the name before its first dot; the rest, if any, is the
    regime the reader is asked for."""
    base = name.split(".", 1)[0]
    return importlib.import_module(f"bench.metrics.{base}")


def read_metrics(bench: Dict, cell: str, run_: Run, trace: bool) -> Dict:
    out = {}
    for m in cell_metrics(bench, cell, trace):
        name = m["name"]
        suffix = name.split(".", 1)[1] if "." in name else None
        if suffix is not None and suffix != run_.regime:
            continue
        value = reader(name).read(run_)
        if value is None:
            continue
        out[name] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))
