"""Closed-loop serving of seeded frames through the port's serving engine.

Traffic parameters (`benchmark/traffic/<mix>.json`):
  batch          the engine's batch (`cli/serve.InferenceEngine`)
  batcher        true: clients call `MicroBatcher.submit` (`max_wait_ms`);
                 false: each client calls `InferenceEngine.infer_batch` alone
  clients        client threads; each sends a frame, waits for its result,
                 sends the next (a closed loop)
  pool_frames    seeded planted frames, cycled by each client in its own
                 seeded order
  objects        [min, max] planted objects a frame
  extent_m       [min, max] class extent, metres
  warm_frames    frames each client completes before the window opens
  judge_calls    engine calls sampled (reservoir, from the seed) for the
                 comparison with the reference
  profile_seconds  the traced sub-window in the middle of a --trace 1 run

Set-up builds the engine as `cli/serve.build_engine` does (its graph is
captured there), copies in the benchmark's weights and the seeded class
extents, and warms the loop. The window then runs for `--seconds`; each
frame is timed from its client's submit to its result. The MicroBatcher's
dispatcher runs on a CPU of its own and the client threads round robin on
the CPUs after it (with 3 CPUs or more): four runs of one seed spread
their frames/s by 16-17% (quartiles over the median) with the threads left
to the scheduler, by 6-8% pinned (PERF.md).
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time

import numpy as np
import torch

from benchmark.lib import host as host_counters
from benchmark.lib.frames import YCB_K, class_extents, planted_frames, rng_for
from benchmark.lib.harness import Outcome
from benchmark.lib.trace import Profile, reduce_trace
from benchmark.reference import judge_serve
from benchmark.reference import posecnn as ref


def port_config(config: dict):
    """The port's Config for the serving engine, from the configuration."""
    from posecnn_torch.core.config import cfg_from_dict

    return cfg_from_dict({
        "compute_dtype": config["compute_dtype"],
        "pixel_means": list(config["pixel_means"]),
        "train": {"num_units": config["num_units"], "fc_dim": config["fc_dim"],
                  "norm_features": config["norm_features"],
                  "quat_activation": config["quat_activation"],
                  "pose_pool_size": config["pose_pool_size"]},
        "test": {"hough_num_samples": config["hough_num_samples"],
                 "nms_threshold": config["nms_threshold"]},
    })


class ServeCell:
    """The engine, its frames and the window's records."""

    def __init__(self, config: dict, traffic: dict, device, seed: int):
        from posecnn_torch.cli.serve import InferenceEngine, MicroBatcher

        t_built = time.perf_counter()
        self.config, self.traffic, self.device = config, traffic, device
        c = config["num_classes"]
        self.extents_np = class_extents(seed, c, *traffic["extent_m"])
        self.engine = InferenceEngine(
            port_config(config), c, None, self.extents_np, None, YCB_K,
            height=config["height"], width=config["width"], batch=traffic["batch"],
            device=str(device))
        self.batcher = (MicroBatcher(self.engine, traffic["max_wait_ms"])
                        if traffic["batcher"] else None)
        self._infer_device = self.engine.infer_device
        self.engine.infer_device = self._sampled_infer_device
        self.sampling = False
        t0 = time.perf_counter()
        self.load(seed)
        self.load_s = time.perf_counter() - t0
        self.built_s = time.perf_counter() - t_built

    # -- inputs

    def load(self, seed: int) -> None:
        """The seed's weights, class extents and frames, copied into the engine."""
        self.seed = seed
        cfg, tr = self.config, self.traffic
        self.extents_np = class_extents(seed, cfg["num_classes"], *tr["extent_m"])
        weights = ref.make_weights(ref.param_specs(cfg), seed, self.device)
        params = dict(self.engine.model.named_parameters())
        if set(params) != set(weights):
            raise RuntimeError(f"the served model's parameters {sorted(set(params) ^ set(weights))} "
                               "differ from the configuration's")
        with torch.no_grad():
            for name, w in weights.items():
                params[name].copy_(w)
            self.engine._extents.copy_(torch.from_numpy(self.extents_np))
        del weights
        self.frames, _ = planted_frames(seed, tr["pool_frames"], cfg["height"], cfg["width"],
                                        cfg["num_classes"], self.extents_np,
                                        tuple(tr["objects"]))
        # each client cycles its own share of the pool in a seeded order, so that
        # no frame is ever in flight twice and a served result names its call
        order = rng_for(seed, 3).permutation(len(self.frames))
        self.orders = [order[i::tr["clients"]] for i in range(tr["clients"])]
        self.reservoir_rng = rng_for(seed, 4)
        self.samples, self.calls = [], 0

    # -- the engine call, sampled for the comparison

    def _sampled_infer_device(self, data_u8, meta):
        out = self._infer_device(data_u8, meta)
        if self.sampling:
            i, k = self.calls, self.traffic["judge_calls"]
            self.calls += 1
            slot = i if i < k else int(self.reservoir_rng.integers(0, i + 1))
            if slot < k:
                kept = (time.perf_counter(), data_u8, tuple(o.clone() for o in out))
                if slot < len(self.samples):
                    self.samples[slot] = kept
                else:
                    self.samples.append(kept)
        return out

    def _spans_a_sample(self, t0: float, t1: float) -> bool:
        """Whether a sampled engine call ran while a request was in flight:
        only such requests' results are kept for the comparison."""
        return any(t0 <= s[0] <= t1 for s in list(self.samples))

    # -- the loop

    def _call(self, image):
        if self.batcher is not None:
            return self.batcher.submit(image, YCB_K)
        return self.engine.infer_batch([image], [YCB_K])[0]

    def serve(self, seconds: float, profile_path: str | None = None,
              profile_seconds: float = 0.0, t_process: float | None = None):
        """Warm, then the window. Returns the window's record."""
        tr = self.traffic
        n = tr["clients"]
        # per request (frame, submitted, served or None, batch size, the
        # engine's batch seconds); the results only of the requests in flight
        # while a sampled engine call ran
        records = [[] for _ in range(n)]
        results = []
        warmed = threading.Barrier(n + 1)
        stop = threading.Event()
        errors = []

        # the main thread sleeps through the window and is left free
        cpus = sorted(os.sched_getaffinity(0))
        pin = len(cpus) >= 3
        if pin and self.batcher is not None:
            os.sched_setaffinity(self.batcher._thread.native_id, {cpus[1]})

        def client(i):
            order, j = self.orders[i], 0
            if pin:
                os.sched_setaffinity(0, {cpus[2 + i % (len(cpus) - 2)]})
            try:
                for _ in range(tr["warm_frames"]):
                    self._call(self.frames[order[j % len(order)]])
                    j += 1
            except Exception as exc:  # noqa: BLE001 — reported as the run's failure
                errors.append(repr(exc))
            warmed.wait()
            while not stop.is_set():
                f = int(order[j % len(order)])
                j += 1
                t0 = time.perf_counter()
                try:
                    res = self._call(self.frames[f])
                    t1 = time.perf_counter()
                    records[i].append((f, t0, t1, res["batch_size"], res["batch_seconds"]))
                    if self._spans_a_sample(t0, t1):
                        results.append((f, t0, t1, res))
                except Exception as exc:  # noqa: BLE001
                    records[i].append((f, t0, None, 0, 0.0))
                    errors.append(repr(exc))

        threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(n)]
        t_warm = time.perf_counter()
        for t in threads:
            t.start()
        try:
            warmed.wait()
            warm_s = time.perf_counter() - t_warm
            if errors:
                raise RuntimeError(f"warm-up failed: {errors[0]}")
            gc.collect()  # set-up's garbage, so that each window starts alike
            host0 = host_counters.counters()
            t_start = time.perf_counter()
            setup_s = time.time() - t_process if t_process is not None else 0.0
            self.sampling = True
            t_end = t_start + seconds
            profile = None
            tracer = None
            if profile_path is not None:
                p0 = t_start + max(0.0, (seconds - profile_seconds) / 2)
                time.sleep(max(0.0, p0 - time.perf_counter()))
                tracer = Profile()
                p0 = time.perf_counter()
                tracer.start()
                time.sleep(profile_seconds)
                # it stops between engine calls: stopping it while another thread
                # launched a graph hung two runs in six
                with self.engine._lock:
                    profile = (p0, time.perf_counter())
                    tracer.stop()
            time.sleep(max(0.0, t_end - time.perf_counter()))
            host = host_counters.counters(host0)
        finally:
            stop.set()
            self.sampling = False
            for t in threads:
                t.join(timeout=60 + seconds)
        if tracer is not None:
            tracer.export(profile_path)
        hung = sum(t.is_alive() for t in threads)
        memory_peak = (torch.cuda.max_memory_allocated(self.device)
                       if self.device.type == "cuda" else 0)
        return dict(records=records, results=results, errors=errors, t_start=t_start, t_end=t_end,
                    setup_s=setup_s, warm_s=warm_s, profile=profile, hung=hung,
                    memory_peak=memory_peak, host=host)

    # -- the comparison

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        if self.batcher is not None:
            self.batcher.engine = None  # its dispatcher waits on an empty queue from now on
        self.engine = self.batcher = self._infer_device = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge_items(self, results):
        """The sampled calls' frames: (image, program label, served
        detections). A row is matched to its frame by its canvas, and to the
        client's result for that frame whose request spans the call."""
        key = {np.ascontiguousarray(f[:, :, ::-1]).tobytes(): i for i, f in enumerate(self.frames)}
        by_frame = {}
        for f, t0, t1, res in results:
            by_frame.setdefault(f, []).append((t0, t1, res))
        items, unmatched = [], 0
        for t_call, data_u8, outs in self.samples:
            label = outs[0]
            canvas = data_u8.cpu().numpy()
            for b in range(canvas.shape[0]):
                f = key.get(canvas[b].tobytes())
                if f is None:
                    continue  # a padding row
                served = [r for t0, t1, r in by_frame.get(f, []) if t0 <= t_call <= t1]
                if not served:
                    unmatched += 1
                    continue
                items.append((self.frames[f], label[b], served[0]["detections"]))
        return items, unmatched


def run(run) -> Outcome:
    tr = run.traffic
    t0 = time.time()
    cell = ServeCell(run.config, tr, run.device, run.seed)
    profile_path = os.path.join(run.tmpdir, "trace.json") if run.trace else None
    rec = cell.serve(run.seconds, profile_path, tr["profile_seconds"], run.t_process)
    print(f"setup: {rec['setup_s']:.3f} s from process start; imports "
          f"{t0 - run.t_process:.3f} s, engine and inputs {cell.built_s:.3f} s, "
          f"weights and frames {cell.load_s:.3f} s, warm-up {rec['warm_s']:.3f} s",
          file=sys.stderr)
    records = rec["records"]
    t_start, t_end = rec["t_start"], rec["t_end"]
    every = [r for client in records for r in client]
    in_window = [r for r in every if t_start <= r[1] < t_end]
    done = [r for r in every if r[2] is not None]
    completed = [r for r in done if t_start <= r[2] < t_end]
    lat_ms = np.array([(r[2] - r[1]) * 1e3 for r in completed])
    # the host-clock per-layer readings are of the window before the profiler
    # starts: tracing, and processing the trace when it stops, slow the host
    p0 = rec["profile"][0] if rec["profile"] else t_end
    steady = [r for r in completed if r[2] < p0]
    observed = dict(
        batch_sizes=[r[3] for r in steady],
        batch_seconds=[r[4] for r in steady],
        steady_frames=len(steady),
        steady_seconds=p0 - t_start,
        flops_per_frame=run.config["flops_per_frame"],
    )
    per_second = np.bincount([int(r[2] - t_start) for r in completed],
                             minlength=int(run.seconds))
    print(f"frames completed each second of the window: {per_second.tolist()}", file=sys.stderr)
    print("host during the window: " + ", ".join(f"{k} {v:.6g}" for k, v in rec["host"].items()),
          file=sys.stderr)
    if completed:
        # a forward's cycle split into the engine's span (replay and fetch)
        # and the rest (canvas, extraction, batching, clients)
        fill = float(np.mean([r[3] for r in completed]))
        cycle_ms = 1e3 * run.seconds * fill / len(completed)
        span_ms = 1e3 * float(np.mean([r[4] for r in completed]))
        print(f"cycle: {cycle_ms:.4f} ms a forward of {fill:.4f} frames; the engine's replay "
              f"and fetch {span_ms:.4f} ms, the rest {cycle_ms - span_ms:.4f} ms", file=sys.stderr)
    if rec["errors"]:
        print(f"failed requests: {len(rec['errors'])}, the first {rec['errors'][0]}",
              file=sys.stderr)
    summary = None
    if rec["profile"] is not None:
        summary = reduce_trace(profile_path)
        os.remove(profile_path)
    end_to_end = dict(
        setup_s=rec["setup_s"],
        frames_per_s=len(completed) / run.seconds,
        frame_p95_ms=float(np.percentile(lat_ms, 95)) if len(lat_ms) else float("inf"),
    )
    items, unmatched = cell.judge_items(rec["results"])
    extents = torch.from_numpy(cell.extents_np).to(run.device)
    cell.release()
    weights = ref.make_weights(ref.param_specs(run.config), run.seed, run.device)
    numbers = judge_serve.judge(weights, run.config, extents, YCB_K, items)
    limits = run.limits("serve")
    checks = {name: (numbers[name], limits[name]) for name in judge_serve.NUMBERS}
    checks.update((name, (numbers[name], 0.0)) for name in judge_serve.EXACT)
    # exact: a sampled frame whose result reached no client, too few frames judged
    checks["unserved_rows"] = (float(unmatched), 0.0)
    checks["judge_shortfall"] = (float(max(0, tr["judge_min_frames"] - len(items))), 0.0)
    failed = sum(1 for r in in_window if r[2] is None) + rec["hung"]
    return Outcome(attempted=len(in_window), failed=failed,
                   end_to_end=end_to_end, checks=checks, memory_peak_bytes=rec["memory_peak"],
                   observed=observed, trace=summary)
