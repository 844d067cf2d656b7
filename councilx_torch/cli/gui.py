"""Interactive translation demo of the port (reference test_gui.py),
mirroring ``councilx/cli/gui.py``: a dependency-free web GUI (stdlib
http.server). Load a checkpoint, open http://localhost:8765, pick an image
of the input folder and a council member (or all), and resample style
codes live; it shows the translations and, for focus models, the masks.

    python -m councilx_torch.cli.gui --config configs/<run>.yaml \
        --checkpoint outputs/<run>/checkpoints --input_folder in/ \
        [--port 8765] [--direction a2b] [--device cuda]

``--checkpoint`` is read as by ``councilx_torch.cli.translate``. The style
code of a render comes from a ``torch.Generator`` seeded with the page's
seed. Endpoints: ``GET /``, ``/meta``, ``/translate?image=&member=&seed=``
(JSON panel list) and ``/img?key=`` (PNG). SIGTERM drains: the server stops
taking requests and the ones in flight finish. On a card each render
replays a CUDA graph captured when the server is made (one per member and
one for all, at one image: ``Translator.captured``).
"""

import argparse
import io
import json
import os
import signal
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!DOCTYPE html>
<html><head><title>councilx demo</title><style>
body{font-family:sans-serif;margin:2em;background:#fafafa}
img{image-rendering:auto;border:1px solid #ccc;margin:4px}
.row{display:flex;gap:16px;flex-wrap:wrap}
.card{background:#fff;padding:12px;border-radius:8px;
      box-shadow:0 1px 3px rgba(0,0,0,.15)}
label{margin-right:1em}
</style></head><body>
<h2>councilx — Council-GAN interactive demo</h2>
<div class="card">
<label>image: <select id="img"></select></label>
<label>member: <select id="member"></select></label>
<label>style seed: <input id="seed" type="number" value="0" style="width:5em">
</label>
<button onclick="document.getElementById('seed').value=
  Math.floor(Math.random()*100000);go()">resample style</button>
<button onclick="go()">translate</button>
</div>
<div class="row" id="out"></div>
<script>
async function init(){
  const meta = await (await fetch('/meta')).json();
  const sel = document.getElementById('img');
  meta.images.forEach(p=>{const o=document.createElement('option');
    o.value=p;o.textContent=p;sel.appendChild(o);});
  const mem = document.getElementById('member');
  const opts = ['all'];
  for(let i=0;i<meta.council_size;i++) opts.push(String(i));
  opts.forEach(v=>{const o=document.createElement('option');
    o.value=v;o.textContent=v==='all'?'all members':'member '+v;
    mem.appendChild(o);});
  go();
}
async function go(){
  const img = document.getElementById('img').value;
  const member = document.getElementById('member').value;
  const seed = document.getElementById('seed').value;
  const out = document.getElementById('out');
  out.innerHTML = '<p>translating…</p>';
  const q = `image=${encodeURIComponent(img)}&member=${member}&seed=${seed}`;
  const meta = await (await fetch('/translate?'+q)).json();
  out.innerHTML = '';
  meta.panels.forEach(p=>{
    const card = document.createElement('div'); card.className='card';
    card.innerHTML = `<div>${p.title}</div><img src="${p.url}&_=${Date.now()}">`;
    out.appendChild(card);
  });
}
init();
</script></body></html>"""


def make_server(cfg, checkpoint: str, input_folder: str, port: int = 8765,
                direction: str = "a2b", device="cuda",
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Load ``checkpoint`` into a ``Translator`` on ``device`` and return
    the (not yet serving) HTTP server of the demo over ``input_folder``."""
    import numpy as np
    import torch
    from PIL import Image

    from councilx_torch.ckpt.manager import load_generator_state_dicts
    from councilx_torch.data.dataset import _load_resize_crop, list_images
    from councilx_torch.data.ondevice import normalize_batch
    from councilx_torch.inference.translate import (Translator,
                                                    denormalize_to_uint8)

    translator = Translator(cfg, device=device)
    gens = translator.load_members(load_generator_state_dicts(
        checkpoint, cfg, direction))
    images = [os.path.relpath(p, input_folder)
              for p in list_images(input_folder)]
    if not images:
        raise SystemExit(f"no images under {input_folder}")
    lock = threading.Lock()
    size = cfg.data.crop_image_height
    style_dim = cfg.gen.style_dim
    # on the card each render replays a captured graph (one image), all
    # captured here; the lock keeps one replay and its readback at a time
    graphs = translator.device.type == "cuda"

    def translate(method: str, params, x, z):
        if graphs:
            return translator.captured(method, params, 1, (size, size))(x, z)
        return getattr(translator, method)(params, x, z)

    if graphs:
        translator.captured("translate_all_members", gens, 1, (size, size))
        for g in gens:
            translator.captured("translate", g, 1, (size, size))

    def render(image_rel: str, member: str, seed: str):
        arr = _load_resize_crop(os.path.join(input_folder, image_rel),
                                cfg.data.new_size, size)
        x = normalize_batch(torch.from_numpy(arr[None]))
        rng = torch.Generator().manual_seed(int(seed))
        with lock:
            # the draws the methods would make from rng
            if member == "all":
                out, mask = translate(
                    "translate_all_members", gens, x,
                    torch.randn((len(gens), 1, style_dim), generator=rng))
                outs = [out[i, 0].cpu().numpy() for i in range(len(gens))]
                masks = ([mask[i, 0].cpu().numpy() for i in range(len(gens))]
                         if mask is not None else None)
            else:
                out, mask = translate(
                    "translate", gens[int(member)], x,
                    torch.randn((1, style_dim), generator=rng))
                outs = [out[0].cpu().numpy()]
                masks = ([mask[0].cpu().numpy()] if mask is not None
                         else None)
        label = (lambda i: i) if member == "all" else (lambda i: member)
        panels = [("input", arr)]
        panels += [(f"member {label(i)}", denormalize_to_uint8(o))
                   for i, o in enumerate(outs)]
        if masks is not None:
            panels += [(f"mask {label(i)}",
                        (np.clip(mk, 0, 1) * 255).astype(np.uint8)
                        .repeat(3, axis=-1)) for i, mk in enumerate(masks)]
        return panels

    cache = {}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            q = dict(urllib.parse.parse_qsl(url.query))
            if url.path == "/":
                self._send(200, _PAGE.encode())
            elif url.path == "/meta":
                self._send(200, json.dumps(
                    {"images": images,
                     "council_size": len(gens)}).encode(),
                    "application/json")
            elif url.path == "/translate":
                image = q.get("image", images[0])
                member = q.get("member", "all")
                seed = q.get("seed", "0")
                if image not in images:
                    self._send(404, b"no such image")
                    return
                if not (member == "all" or (member.isdigit()
                                            and int(member) < len(gens))):
                    self._send(400, b"bad member")
                    return
                if not seed.lstrip("-").isdigit():
                    self._send(400, b"bad seed")
                    return
                out = []
                for i, (title, arr) in enumerate(render(image, member,
                                                        seed)):
                    key = f"{image}|{member}|{seed}|{i}"
                    cache[key] = arr
                    out.append({"title": title,
                                "url": "/img?key="
                                       + urllib.parse.quote(key)})
                self._send(200, json.dumps({"panels": out}).encode(),
                           "application/json")
            elif url.path == "/img":
                arr = cache.get(q.get("key", ""))
                if arr is None:
                    self._send(404, b"gone")
                    return
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, "PNG")
                self._send(200, buf.getvalue(), "image/png")
            else:
                self._send(404, b"not found")

    print(f"loaded checkpoint {checkpoint}; {len(images)} images; "
          f"council_size={len(gens)}", flush=True)
    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--input_folder", required=True)
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--direction", default="a2b", choices=["a2b", "b2a"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from councilx_torch.config import load_config

    srv = make_server(load_config(args.config), args.checkpoint,
                      args.input_folder, args.port, args.direction,
                      args.device)

    # graceful SIGTERM drain: shutdown() from another thread makes
    # serve_forever return; in-flight responses finish
    def _drain(signum, frame):
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    print(f"serving on http://localhost:{args.port}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
