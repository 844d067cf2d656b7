"""Batched translation server for a trained council member, on PyTorch.

Counterpart of ``councilx/cli/serve.py``:

    python -m councilx_torch.cli.serve --config configs/soak_256_council4.yaml \
        --checkpoint gen.pt --member 0 [--port 8766] [--max_batch 64] \
        [--max_delay_ms 5] [--device cuda]

``--checkpoint`` is a reference-layout ``.pt`` or a JAX-package ``.npz``
export (councilx_torch.ckpt.manager). Concurrent POSTs are coalesced by
councilx_torch.inference.server.BatchingEngine into padded batches, run
through the on-device uint8 translate path, and returned as JPEG.
Endpoints:

    POST /translate[?seed=N][&quality=Q][&z=f1,f2,...]
                                           image bytes in, JPEG out; z is
                                           an explicit style code (from
                                           /encode_style)
    POST /encode_style                     style image bytes in, its style
                                           code out as JSON {"z": [...]}
    GET  /healthz                          liveness + config summary
    GET  /stats                            batching/latency counters:
                                           requests, batches, padded
                                           rows, the batch-size
                                           histogram, mean_latency_ms
                                           (submit to resolved) and
                                           mean_stage_ms, its split into
                                           queue, coalesce, dispatch,
                                           inflight and resolve

W8A8 int8 serving: ``--quant w8a8`` (per-image activation scales), or
``--quant w8a8_static --calibration quant_stats.npz`` (scales from
``python -m councilx_torch.tools.calibrate_quant``, or the JAX package's
``tools/calibrate_quant.py``: the same file), quantizing the convs of the
config's ``quant_scope``.

Several devices, in this one process: ``--data_parallel D`` splits each
batch of one member over D devices (``ShardedTranslator``; buckets and
``--max_batch`` multiples of D); with ``--member all`` it splits the
members instead, as ``--member_parallel K`` does (``MemberShardedTranslator``,
K must divide the council), and both together split the batch over D and
the members over K (D*K devices). The translators use the first D*K cards
(``--device cpu``: the CPU, D*K times); more than the machine has is
refused. Member parallelism needs ``--member all``; ``--calibration`` does
not go with ``--member all``.
"""

import argparse
import io
import json
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# request bodies above this are refused (413); a socket idle this long is
# dropped, so a slow client cannot hold a handler thread
MAX_BODY_BYTES = 32 * 1024 * 1024
READ_TIMEOUT_S = 30


def preprocess_bytes(data: bytes, new_size: int, crop: int):
    """Image bytes -> (crop, crop, 3) uint8 — the CLI preprocessing
    (shorter-side bilinear resize + center crop). Pixels stay uint8; the
    device normalizes them."""
    from PIL import Image

    from councilx_torch.data.dataset import resize_crop_image

    return resize_crop_image(Image.open(io.BytesIO(data)), new_size, crop)


def build_engine(cfg, checkpoint: str, member, direction: str,
                 max_batch: int, max_delay_ms: float, data_parallel: int = 0,
                 warmup: bool = True, calibration: str = None,
                 member_parallel: int = 0, device="cuda"):
    """Load ``checkpoint``, build the translator on ``device`` (default: the
    card; without one this raises -- serving on the CPU takes
    ``device="cpu"``) and start a BatchingEngine serving ``member`` (an
    index, or "all" for the council ensemble). ``calibration``: the
    ``quant_stats`` .npz of ``cfg.quant`` "w8a8_static" (one member's)."""
    from councilx_torch.ckpt.manager import load_generator_state_dicts
    from councilx_torch.inference.server import BatchingEngine
    from councilx_torch.inference.translate import (MemberShardedTranslator,
                                                    ShardedTranslator,
                                                    Translator)
    from councilx_torch.parallel.mesh import local_devices, make_member_mesh

    all_members = member == "all"
    if calibration and all_members:
        raise SystemExit(
            "--member all cannot use --calibration: the activation "
            "scales are calibrated per member (calibrate_quant "
            "--member); quantized ensemble serving would silently clip "
            "the other members' activations")
    if member_parallel > 1 and not all_members:
        raise SystemExit("--member_parallel shards the council axis: it "
                         "requires --member all")
    # one member splits its batch over D; the ensemble splits its members
    # over K (--member_parallel, or --data_parallel alone, as the JAX CLI
    # reads it), and with both flags its batch over D too
    if not all_members:
        shards, dp = 1, max(1, data_parallel)
    elif member_parallel > 1:
        shards, dp = member_parallel, max(1, data_parallel)
    else:
        shards, dp = max(1, data_parallel), 1
    if cfg.council.council_size % shards:
        raise SystemExit(f"member shards {shards} must divide council_size "
                         f"{cfg.council.council_size}")
    if max_batch % dp:
        raise SystemExit(f"--max_batch {max_batch} must be a multiple of "
                         f"--data_parallel {dp}")
    try:
        devices = (local_devices(shards * dp, device)
                   if shards * dp > 1 else None)
    except ValueError as e:
        raise SystemExit(f"--data_parallel/--member_parallel: {e}") from None
    quant_stats = None
    if calibration:
        from councilx_torch.ckpt.manager import load_params_npz
        quant_stats = load_params_npz(calibration)
    if shards > 1:
        translator = MemberShardedTranslator(
            cfg, make_member_mesh(shards, devices, data_parallel=dp))
    elif dp > 1:
        translator = ShardedTranslator(cfg, devices, quant_stats=quant_stats)
    else:
        translator = Translator(cfg, quant_stats=quant_stats, device=device)
    state_dicts = load_generator_state_dicts(checkpoint, cfg, direction)
    if all_members:
        params = translator.load_members(state_dicts)
    else:
        params = translator.load_members([state_dicts[int(member)]])[0]
    crop = cfg.data.crop_image_height
    engine = BatchingEngine(translator, params, image_hw=(crop, crop),
                            max_batch=max_batch, max_delay_ms=max_delay_ms,
                            all_members=all_members)
    engine.start()
    if warmup:
        engine.warmup()
    return engine


def make_handler(engine, cfg):
    import numpy as np
    from PIL import Image

    new_size = cfg.data.new_size
    crop = cfg.data.crop_image_height

    class Handler(BaseHTTPRequestHandler):
        timeout = READ_TIMEOUT_S

        def log_message(self, *a):      # quiet access log
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/healthz":
                self._json({"ok": True, "serving_hw": list(engine.image_hw),
                            "buckets": engine.buckets,
                            "wire_format": engine.wire_format,
                            "members": engine.n_members,
                            "device": str(engine.translator.device),
                            "max_delay_ms": engine.max_delay_s * 1e3})
            elif path == "/stats":
                self._json(engine.snapshot_stats())
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path not in ("/translate", "/encode_style"):
                self._json({"error": "not found"}, 404)
                return
            q = urllib.parse.parse_qs(parsed.query)
            try:
                seed = int(q.get("seed", ["0"])[0])
                quality = int(q.get("quality", ["95"])[0])
            except ValueError:
                self._json({"error": "seed/quality must be integers"}, 400)
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._json({"error": "bad Content-Length header"}, 400)
                return
            if length <= 0:
                self._json({"error": "empty body"}, 400)
                return
            if length > MAX_BODY_BYTES:
                self._json({"error": f"body over {MAX_BODY_BYTES} bytes"},
                           413)
                return
            data = self.rfile.read(length)
            try:
                x = preprocess_bytes(data, new_size, crop)
            except Exception as e:
                self._json({"error": f"bad image: {e}"}, 400)
                return
            if parsed.path == "/encode_style":
                try:
                    zv = engine.encode_style(x)
                except Exception as e:
                    self._json({"error": f"encode failed: {e}"}, 500)
                    return
                self._json({"z": [float(v) for v in zv]})
                return
            z = None
            if "z" in q:
                try:
                    z = np.asarray([float(v) for v in
                                    q["z"][0].split(",")], np.float32)
                except ValueError:
                    self._json({"error": "z must be comma-separated "
                                         "floats"}, 400)
                    return
                if z.shape != (engine.style_dim,):
                    self._json({"error": f"z needs {engine.style_dim} "
                                         f"values, got {z.size}"}, 400)
                    return
            try:
                out = engine.translate_sync(x, z=z, seed=seed, timeout=1200)
            except Exception as e:
                self._json({"error": f"translate failed: {e}"}, 500)
                return
            if engine.all_members:      # (N,H,W,3) -> horizontal strip
                out = np.concatenate(list(out), axis=1)
            buf = io.BytesIO()
            Image.fromarray(out).save(buf, format="JPEG", quality=quality)
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "image/jpeg")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Members", str(engine.n_members))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def main(argv=None):
    from councilx_torch.config import load_config

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="reference-layout .pt, or a .npz export of the JAX "
                        "package's generator tree")
    p.add_argument("--member", default="0",
                   help="member index, or 'all' for council-ensemble "
                        "serving (every member's translation per request, "
                        "returned as a horizontal JPEG strip)")
    p.add_argument("--direction", default="a2b", choices=["a2b", "b2a"])
    p.add_argument("--port", type=int, default=8766)
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--max_delay_ms", type=float, default=5.0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; cpu serves on the CPU)")
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="serve over this many devices: the BATCH axis for a "
                        "single member, the MEMBER axis with --member all "
                        "(must divide council_size)")
    p.add_argument("--member_parallel", type=int, default=0,
                   help="with --member all: shard the council axis over "
                        "this many devices; with --data_parallel D too, a "
                        "D x K grid that splits the batch as well")
    p.add_argument("--quant", default=None,
                   choices=["none", "w8a8", "w8a8_static"],
                   help="override cfg.quant: W8A8 int8 generator convs "
                        "(w8a8_static needs --calibration)")
    p.add_argument("--calibration", default=None,
                   help="quant_stats .npz from councilx_torch.tools."
                        "calibrate_quant (required for --quant "
                        "w8a8_static)")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    if args.quant is not None:
        cfg.quant = args.quant
    engine = build_engine(cfg, args.checkpoint, args.member, args.direction,
                          args.max_batch, args.max_delay_ms,
                          args.data_parallel, warmup=not args.no_warmup,
                          calibration=args.calibration,
                          member_parallel=args.member_parallel,
                          device=args.device)
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_handler(engine, cfg))

    # graceful drain on SIGTERM: stop accepting, let in-flight requests
    # finish, flush the engine, exit 0. shutdown() must run on another
    # thread — it blocks until serve_forever (on THIS thread) returns.
    import signal
    import threading

    def _drain(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)

    print(f"serving member {args.member} on http://localhost:{args.port} "
          f"(device {engine.translator.device}, buckets {engine.buckets}, "
          f"delay {args.max_delay_ms} ms)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        engine.stop()
        server.server_close()
        print("drained; exiting", flush=True)


if __name__ == "__main__":
    main()
