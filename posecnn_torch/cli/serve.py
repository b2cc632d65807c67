"""Inference serving API (ROS-free deployment), on PyTorch/CUDA.

Counterpart of `posecnn_tpu/cli/serve.py`, with the same HTTP contract:

  POST /infer   body: {"image": [[...]] RGB uint8 HxWx3 (or base64
                 "image_b64" of raw bytes + "shape"), optional
                 "intrinsics": 3x3, optional "return_label": true}
  → {"detections": [{"class", "class_name", "quat_wxyz", "trans",
       "roi", "score"}], "label_shape": [H, W], "seconds": t,
     "batch_seconds": t, "batch_size": n[, "label_rle": {...}]}
  GET /healthz  → {"ok": true}

The model runs at a fixed input size and batch; smaller inputs are
placed in the top-left corner of the canvas. `--batch N` coalesces
concurrent requests into one forward (MicroBatcher). On the card the
forward with its per-class NMS (the scan on the device, `nms_scan_kernel`)
runs as one CUDA graph, captured when the engine starts
(`utils/graph.compile_static`, as the JAX engine jits the forward and
`nms_per_class` at its batch); `--device cpu` runs it eagerly.

    python -m posecnn_torch.cli.serve --port 8475          # serve forever
    python -m posecnn_torch.cli.serve --bench 20           # one JSON latency line

The class geometry (the extents Hough's box gate and the RoIs use) is
YCB-Video's from `--data_root` (`models/`, `extents.txt`), else the
procedural stand-in library, whose extents are wrong for a checkpoint
trained on the real objects.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer

import numpy as np
import torch

from posecnn_torch.cli.common import (
    YCB_K,
    base_parser,
    forward_with_nms,
    head_flags_from_ckpt,
    load_config,
    setup_device,
)
from posecnn_torch.core.checkpoint import restore_for_eval
from posecnn_torch.engine.evaluate import extract_detections
from posecnn_torch.models.posecnn import PoseCNN, init_weights
from posecnn_torch.utils.graph import compile_static


class InferenceEngine:
    """Fixed-shape PoseCNN inference at a static batch size on one device.

    `infer_device` runs the forward compiled (one CUDA graph at the
    engine's batch and canvas, captured in `__init__`; eager on the CPU);
    `_compiled.fn` is its body, run eagerly."""

    def __init__(self, cfg, num_classes, points, extents, symmetry, k,
                 height=480, width=640, ckpt=None, class_names=None,
                 batch=1, device="cuda"):
        self.device = setup_device(str(device))
        self.height, self.width = height, width
        self.num_classes = num_classes
        self.class_names = class_names or [str(i) for i in range(num_classes)]
        self.batch = int(batch)
        self.nms_threshold = cfg.test.nms_threshold
        # bf16 compute on the card (cfg.compute_dtype); fp32 on the CPU
        compute_dtype = (
            getattr(torch, cfg.compute_dtype) if self.device.type == "cuda" else torch.float32
        )

        model = PoseCNN(
            num_classes,
            num_units=cfg.train.num_units,
            fc_dim=cfg.train.fc_dim,
            **head_flags_from_ckpt(cfg, ckpt),
            compute_dtype=compute_dtype,
            hough_num_samples=cfg.test.hough_num_samples,
            max_objects=16,
        )
        # every head; a switched model's checkpoint keeps the seeded
        # values of the heads it lacks (core/checkpoint.restore_for_eval)
        init_weights(model, cfg.rng_seed)
        if ckpt:
            restore_for_eval(ckpt, model)
        self.model = model.to(self.device).eval()
        self._extents = torch.as_tensor(np.asarray(extents, np.float32), device=self.device)
        self._pixel_means = torch.tensor(cfg.pixel_means, dtype=torch.float32, device=self.device)
        meta0 = np.zeros((self.batch, 48), np.float32)
        meta0[:, :9] = k.flatten()
        meta0[:, 9:18] = np.linalg.inv(k).flatten()
        self._meta0 = meta0
        self._compiled = compile_static(self._body)
        # one caller at a time on the graph's static buffers
        self._lock = threading.Lock()
        # warm up and capture: builds the CUDA kernels, the cuDNN plans and the graph
        self.infer_device(
            torch.zeros((self.batch, height, width, 3), dtype=torch.uint8, device=self.device),
            torch.from_numpy(meta0).to(self.device),
        )

    @torch.inference_mode()
    def _body(self, data_u8: torch.Tensor, meta: torch.Tensor):
        """The compiled program: the uint8 cast, the mean subtraction, the
        model and its per-class NMS."""
        out, keep = forward_with_nms(self.model, data_u8.float() - self._pixel_means,
                                     self._extents, meta, self.nms_threshold)
        return out.label_2d, out.hough.rois, out.hough.poses_init, out.poses_pred, keep

    def infer_device(self, data_u8: torch.Tensor, meta: torch.Tensor):
        """One forward on device tensors, compiled: (B, H, W, 3) uint8 BGR
        and (B, 48) meta at the engine's batch and canvas. Returns
        (label_2d, rois, poses_init, poses_pred, keep) on the device, the
        graph's outputs, which the next call overwrites (`infer_batch`
        reads them under the engine's lock)."""
        return self._compiled(data_u8, meta)

    def __call__(self, image_rgb: np.ndarray, k: np.ndarray | None = None,
                 want_label: bool = False) -> dict:
        return self.infer_batch([image_rgb], [k], [want_label])[0]

    @staticmethod
    def _rle_label(label: np.ndarray) -> dict:
        """Row-major run-length encoding of an int label map:
        counts = [v0, n0, v1, n1, ...]."""
        flat = label.reshape(-1)
        change = np.nonzero(np.diff(flat))[0] + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [flat.size]])
        counts = np.empty(2 * starts.size, np.int64)
        counts[0::2] = flat[starts]
        counts[1::2] = ends - starts
        return {"shape": list(label.shape), "counts": counts.tolist()}

    def infer_batch(self, images, ks, want_label=None) -> list[dict]:
        """Run ≤ `self.batch` frames in one forward; short batches are
        padded to the fixed size. Each frame's detections are split back
        out by the RoI buffer's batch column."""
        n = len(images)
        if n > self.batch:
            raise ValueError(f"infer_batch got {n} frames, engine batch is {self.batch}")
        canvas = np.zeros((self.batch, self.height, self.width, 3), np.uint8)
        meta = self._meta0.copy()
        for b, (image_rgb, k) in enumerate(zip(images, ks)):
            h, w = image_rgb.shape[:2]
            ch, cw = min(h, self.height), min(w, self.width)
            canvas[b, :ch, :cw] = image_rgb[:ch, :cw, ::-1]
            if k is not None:
                meta[b, :9] = np.asarray(k, np.float32).flatten()
                meta[b, 9:18] = np.linalg.inv(np.asarray(k, np.float64)).astype(np.float32).flatten()
        t0 = time.perf_counter()
        with self._lock:
            label, rois, poses_init, poses_pred, keep = self.infer_device(
                torch.from_numpy(canvas).to(self.device), torch.from_numpy(meta).to(self.device)
            )
            rois_np = rois.cpu().numpy()
            keep_np = keep.cpu().numpy()
            init_np = poses_init.cpu().numpy()
            pred_np = poses_pred.cpu().numpy()
            # fetch the (B, H, W) label map only when a client asked for it
            label_np = (
                label.cpu().numpy() if want_label is not None and any(want_label) else None
            )
        dt = time.perf_counter() - t0
        out = []
        for b in range(n):
            mine = keep_np & (rois_np[:, 0].astype(np.int32) == b)
            dets = extract_detections(
                rois_np, init_np, pred_np, mine, self.num_classes, with_indices=True
            )
            out.append({
                "detections": [
                    {
                        "class": int(cls),
                        "class_name": self.class_names[int(cls)],
                        "quat_wxyz": np.asarray(q).tolist(),
                        "trans": np.asarray(t).tolist(),
                        "roi": rois_np[i, 2:6].tolist(),
                        "score": float(rois_np[i, 6]),
                    }
                    for cls, q, t, i in dets
                ],
                "label_shape": [self.height, self.width],
                **(
                    {"label_rle": self._rle_label(label_np[b])}
                    if label_np is not None and want_label[b]
                    else {}
                ),
                # per-frame share of the forward: one forward serves n
                # coalesced requests
                "seconds": dt / max(n, 1),
                "batch_seconds": dt,
                "batch_size": n,
            })
        return out


class MicroBatcher:
    """Coalesces concurrent requests into one forward.

    A dispatcher thread sleeps until a request arrives, then waits up
    to `max_wait_ms` (or until the batch fills) before calling
    `engine.infer_batch`."""

    def __init__(self, engine: InferenceEngine, max_wait_ms: float = 10.0):
        self.engine = engine
        self.max_wait = max_wait_ms / 1000.0
        self._cv = threading.Condition()
        self._pending: list = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, k: np.ndarray | None,
               want_label: bool = False) -> dict:
        box: dict = {"event": threading.Event()}
        with self._cv:
            self._pending.append((image, k, want_label, box))
            self._cv.notify()
        box["event"].wait()
        if "error" in box:
            raise RuntimeError(box["error"])
        return box["result"]

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending:
                    self._cv.wait()
                deadline = time.perf_counter() + self.max_wait
                while len(self._pending) < self.engine.batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = self._pending[: self.engine.batch]
                del self._pending[: len(batch)]
            try:
                results = self.engine.infer_batch(
                    [b[0] for b in batch], [b[1] for b in batch], [b[2] for b in batch],
                )
                for (_, _, _, box), res in zip(batch, results):
                    box["result"] = res
                    box["event"].set()
            except Exception as exc:  # noqa: BLE001 — fail the waiters, not the loop
                for _, _, _, box in batch:
                    box["error"] = str(exc)
                    box["event"].set()


def _decode_image(payload: dict) -> np.ndarray:
    if "image_b64" in payload:
        raw = base64.b64decode(payload["image_b64"])
        return np.frombuffer(raw, np.uint8).reshape(payload["shape"])
    return np.asarray(payload["image"], np.uint8)


def make_handler(engine: InferenceEngine, batcher: MicroBatcher | None = None):
    """HTTP handler; with a `batcher`, requests queue for coalesced
    dispatch (serve with ThreadingHTTPServer so they can overlap)."""
    run = batcher.submit if batcher is not None else engine

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/infer":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                image = _decode_image(payload)
                k = np.asarray(payload["intrinsics"], np.float32) if "intrinsics" in payload else None
                want_label = bool(payload.get("return_label", False))
                self._send(200, run(image, k, want_label))
            except Exception as exc:  # noqa: BLE001 — report to client
                self._send(400, {"error": str(exc)})

    return Handler


def build_engine(args) -> InferenceEngine:
    """The engine `main` serves: YCB-Video's 22 classes with the class
    geometry of `--data_root`, or the procedural stand-in."""
    from posecnn_torch.data.datasets import YCB_CLASSES, YCB_SYMMETRY, YCBVideoDataset
    from posecnn_torch.data.procedural import synthetic_class_library

    cfg = load_config(args)
    c = len(YCB_CLASSES)
    if args.data_root:
        ds = YCBVideoDataset(args.data_root, "train", num_points=512)
        points, extents = ds.points, ds.extents
    else:
        print("serve: no --data_root; using synthetic stand-in class geometry (wrong extents "
              "for real checkpoints)", flush=True)
        proc = synthetic_class_library(c, 512)
        points, extents = proc.points, proc.extents
    return InferenceEngine(
        cfg, c, points, extents, YCB_SYMMETRY, YCB_K,
        height=args.height, width=args.width, ckpt=args.ckpt,
        class_names=list(YCB_CLASSES), batch=max(1, args.batch), device=args.device,
    )


def make_parser():
    parser = base_parser("PoseCNN inference server (PyTorch/CUDA)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8475)
    parser.add_argument("--ckpt", default=None, help="JAX .npz checkpoint (save_params layout)")
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument(
        "--bench", type=int, default=0,
        help="run N steady-state requests through the HTTP path and "
        "print one JSON latency line instead of serving forever",
    )
    parser.add_argument(
        "--batch", type=int, default=1,
        help="engine batch size; >1 enables micro-batched dispatch",
    )
    parser.add_argument(
        "--batch_wait_ms", type=float, default=10.0,
        help="max time the dispatcher waits to fill a batch",
    )
    parser.add_argument(
        "--concurrency", type=int, default=0,
        help="--bench client threads (default: --batch)",
    )
    parser.add_argument(
        "--data_root", default=None,
        help="dataset root with models/ and extents.txt: the real class geometry (default: "
        "the procedural stand-in, whose extents are wrong for real checkpoints)",
    )
    return parser


def make_server(engine: InferenceEngine, host: str, port: int, batch_wait_ms: float = 10.0):
    """The HTTP server for `engine`: threaded with a MicroBatcher when
    the engine batch is > 1, plain otherwise."""
    if engine.batch > 1:
        return ThreadingHTTPServer(
            (host, port), make_handler(engine, MicroBatcher(engine, batch_wait_ms))
        )
    return HTTPServer((host, port), make_handler(engine))


def main(argv=None):
    args = make_parser().parse_args(argv)
    engine = build_engine(args)
    server = make_server(engine, args.host, args.port, args.batch_wait_ms)
    if args.bench > 0:
        return _bench(server, engine, args)
    print(f"serving on http://{args.host}:{args.port} (POST /infer, batch={engine.batch})")
    server.serve_forever()


def _bench(server, engine, args):
    """Steady-state latency through the real HTTP path: the server in a
    thread, `--bench` POST /infer requests with a full-size image after
    a warm-up, percentiles printed as ONE JSON line."""
    import http.client

    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    port = server.server_address[1]
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (args.height, args.width, 3), np.uint8)
    payload = json.dumps(
        {"image_b64": base64.b64encode(img.tobytes()).decode(), "shape": list(img.shape)}
    )

    def one_request():
        conn = http.client.HTTPConnection(args.host, port, timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", "/infer", body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        dt = time.perf_counter() - t0
        conn.close()
        if resp.status != 200:
            raise RuntimeError(f"request failed: {body}")
        return dt * 1000, body["seconds"] * 1000

    conc = args.concurrency or max(1, args.batch)
    lat, dev, lock = [], [], threading.Lock()
    try:
        for _ in range(2 * conc):  # warm-up
            one_request()
        conc = min(conc, args.bench)
        base, rem = divmod(max(args.bench, conc), conc)
        counts = [base + (1 if i < rem else 0) for i in range(conc)]

        def client(n_req):
            for _ in range(n_req):
                d, s = one_request()
                with lock:
                    lat.append(d)
                    dev.append(s)

        tw0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in counts]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - tw0
    finally:
        server.shutdown()
        server.server_close()
    lat_s = np.sort(lat)
    out = {
        "metric": "torch_serve_http_latency",
        "unit": "ms",
        "value": float(np.median(lat_s)),
        "p90_ms": float(lat_s[int(0.9 * (len(lat_s) - 1))]),
        "mean_forward_ms": float(np.mean(dev)),
        "throughput_rps": len(lat_s) / wall,
        "n": len(lat_s),
        "batch": args.batch,
        "concurrency": conc,
        "height": args.height,
        "width": args.width,
        "device": (torch.cuda.get_device_name(engine.device)
                   if engine.device.type == "cuda" else str(engine.device)),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
