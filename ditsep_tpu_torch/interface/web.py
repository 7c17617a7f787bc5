"""Dependency-free web demo server over the interface backends (port of
ditsep_tpu/interface/web.py).

A plain ``http.server`` application with a single-page HTML front end:
the demo's tab surface runs and is tested with the standard library only.
Processing goes through the backends in ``ditsep_tpu_torch.interface.app``;
this file is transport and WAV codec glue. A route whose backend was not
given answers 404 "backend not loaded". /api/generate_cond passes a JSON
prompt string through as it is: a T5 conditioner needs embeddings, so
over HTTP the route serves number, int and list conditioning only, as the
JAX package's does.

API (all responses JSON unless noted):
  GET  /                  single-page UI
  GET  /api/info          available tabs, sample rates
  POST /api/separate      body=wav; query n_steps/snr/corrector_steps/seed
                          -> {"fs", "sources": [b64 wav, ...]}
  POST /api/autoencoder   body=wav; query latent_noise/seed -> audio/wav
  POST /api/generate      body=JSON {steps,seed,sigma_min,sigma_max}
                          -> audio/wav
  POST /api/generate_cond body=JSON {cond:{...},steps,cfg_scale,seed}
                          -> audio/wav
  POST /api/lm            body=JSON {length,temperature,top_k,top_p,seed}
                          -> audio/wav (or {"codes": ...} without a codec)
"""
from __future__ import annotations

import base64
import io
import json
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np


# ---------------------------------------------------------------------------
# WAV codec (stdlib `wave`, 16-bit PCM out; 8-, 16- and 32-bit in), so the
# server needs nothing beyond numpy.
# ---------------------------------------------------------------------------

def encode_wav(data: np.ndarray, fs: int) -> bytes:
    """float32 (T,) or (C, T) in [-1, 1] -> 16-bit PCM WAV bytes."""
    data = np.atleast_2d(np.asarray(data, np.float32))  # (C, T)
    pcm = np.round(np.clip(data, -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(int(fs))
        w.writeframes(pcm.T.tobytes())  # interleaved
    return buf.getvalue()


def decode_wav(payload: bytes) -> tuple[np.ndarray, int]:
    """WAV bytes -> (float32 (T, C), fs): the (T, C) layout the app
    backends' input hygiene expects."""
    with wave.open(io.BytesIO(payload), "rb") as w:
        n, ch, width = w.getnframes(), w.getnchannels(), w.getsampwidth()
        fs = w.getframerate()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    return data.reshape(-1, ch), fs


# ---------------------------------------------------------------------------
# HTML front end (one page; tabs appear per available backend)
# ---------------------------------------------------------------------------

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ditsep_tpu_torch demo</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;max-width:52rem}
 fieldset{margin:1rem 0;border:1px solid #bbb;border-radius:6px}
 label{margin-right:.8rem}input[type=number]{width:5.5rem}
 button{margin-top:.5rem}audio{display:block;margin:.4rem 0}
 .err{color:#b00}
</style></head><body>
<h1>ditsep_tpu_torch — diffusion audio separation (CUDA)</h1>
<div id="tabs"></div>
<script>
async function run(path, opts, out){
  out.textContent = "running...";
  try{
    const r = await fetch(path, opts);
    if(!r.ok){ out.innerHTML =
      '<span class=err>'+(await r.text())+'</span>'; return; }
    const ct = r.headers.get('content-type')||'';
    out.textContent = '';
    if(ct.startsWith('audio/')){
      const a = document.createElement('audio'); a.controls = true;
      a.src = URL.createObjectURL(await r.blob()); out.appendChild(a);
    } else {
      const j = await r.json();
      (j.sources||[]).forEach(b64=>{
        const a = document.createElement('audio'); a.controls = true;
        a.src = 'data:audio/wav;base64,'+b64; out.appendChild(a); });
      if(j.codes) out.textContent = 'codes: '+JSON.stringify(j.codes);
    }
  }catch(e){ out.innerHTML = '<span class=err>'+e+'</span>'; }
}
function num(id){ return document.getElementById(id).value; }
function tab(title, inner){
  const f = document.createElement('fieldset');
  f.innerHTML = '<legend>'+title+'</legend>'+inner;
  document.getElementById('tabs').appendChild(f); return f; }
fetch('/api/info').then(r=>r.json()).then(info=>{
 if(info.separation) {
  tab('Separate', `<input type=file id=sep_f accept=.wav>
   <label>N <input type=number id=sep_n value=30></label>
   <label>snr <input type=number id=sep_s value=0.5 step=0.1></label>
   <label>corrector <input type=number id=sep_c value=1></label>
   <label>seed <input type=number id=sep_seed value=0></label>
   <button onclick="sep()">Separate</button><div id=sep_out></div>`);
  window.sep = ()=>{
   const f = document.getElementById('sep_f').files[0];
   run('/api/separate?n_steps='+num('sep_n')+'&snr='+num('sep_s')
       +'&corrector_steps='+num('sep_c')+'&seed='+num('sep_seed'),
       {method:'POST', body:f}, document.getElementById('sep_out'));};
 }
 if(info.autoencoder){
  tab('Autoencoder', `<input type=file id=ae_f accept=.wav>
   <label>latent noise <input type=number id=ae_n value=0 step=0.1></label>
   <button onclick="ae()">Reconstruct</button><div id=ae_out></div>`);
  window.ae = ()=>{
   const f = document.getElementById('ae_f').files[0];
   run('/api/autoencoder?latent_noise='+num('ae_n'),
       {method:'POST', body:f}, document.getElementById('ae_out'));};
 }
 if(info.generation){
  tab('Generate (unconditional)',
   `<label>steps <input type=number id=g_st value=50></label>
    <label>seed <input type=number id=g_sd value=0></label>
    <label>sigma_min <input type=number id=g_mn value=0.3 step=0.1></label>
    <label>sigma_max <input type=number id=g_mx value=50></label>
    <button onclick="gen()">Generate</button><div id=g_out></div>`);
  window.gen = ()=>run('/api/generate', {method:'POST',
   body: JSON.stringify({steps:+num('g_st'), seed:+num('g_sd'),
     sigma_min:+num('g_mn'), sigma_max:+num('g_mx')})},
   document.getElementById('g_out'));
 }
 if(info.generation_cond){
  tab('Generate (prompt)', `<label>prompt <input id=c_p size=30></label>
   <label>seconds <input type=number id=c_secs value=10></label>
   <label>CFG <input type=number id=c_cfg value=6 step=0.5></label>
   <label>steps <input type=number id=c_st value=100></label>
   <label>seed <input type=number id=c_sd value=0></label>
   <button onclick="genc()">Generate</button><div id=c_out></div>`);
  window.genc = ()=>run('/api/generate_cond', {method:'POST',
   body: JSON.stringify({cond:{prompt:document.getElementById('c_p').value,
     seconds_start:0, seconds_total:+num('c_secs')},
     cfg_scale:+num('c_cfg'), steps:+num('c_st'), seed:+num('c_sd')})},
   document.getElementById('c_out'));
 }
 if(info.lm){
  tab('Token LM', `<label>length <input type=number id=l_n value=64></label>
   <label>temp <input type=number id=l_t value=1 step=0.1></label>
   <label>top-k <input type=number id=l_k value=250></label>
   <label>top-p <input type=number id=l_p value=0 step=0.05></label>
   <label>seed <input type=number id=l_sd value=0></label>
   <button onclick="lm()">Generate</button><div id=l_out></div>`);
  window.lm = ()=>run('/api/lm', {method:'POST',
   body: JSON.stringify({length:+num('l_n'), temperature:+num('l_t'),
     top_k:+num('l_k'), top_p:+num('l_p'), seed:+num('l_sd')})},
   document.getElementById('l_out'));
 }
});
</script></body></html>
"""


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

def _q1(qs: Dict[str, list], key: str, cast, default):
    v = qs.get(key)
    return cast(v[0]) if v else default


class DemoServer:
    """Stdlib HTTP demo server over any subset of interface backends:
    pass the backends you have, the matching tabs and endpoints appear.
    Start with ``serve_forever()`` (blocking) or ``start()`` (daemon
    thread; use ``.port`` and ``close()``, as the tests do)."""

    def __init__(self, separation=None, autoencoder=None, generation=None,
                 lm=None, host: str = "127.0.0.1", port: int = 0):
        self.separation, self.autoencoder = separation, autoencoder
        self.generation, self.lm = generation, lm
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # one model call at a time: the backends share device state
            lock = threading.Lock()

            def log_message(self, *a):  # quiet by default
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200):
                self._send(code, json.dumps(obj).encode(),
                           "application/json")

            def _fail(self, msg: str, code=400):
                self._send(code, msg.encode(), "text/plain")

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(n)

            def do_GET(self):
                path = urlparse(self.path).path
                if path in ("/", "/index.html"):
                    self._send(200, _PAGE.encode(),
                               "text/html; charset=utf-8")
                elif path == "/api/info":
                    self._json(outer.info())
                else:
                    self._fail("not found", 404)

            def do_POST(self):
                u = urlparse(self.path)
                qs = parse_qs(u.query)
                try:
                    with self.lock:
                        self._route(u.path, qs)
                except BrokenPipeError:
                    pass
                except Exception as e:  # surface errors to the page
                    self._fail(f"{type(e).__name__}: {e}", 500)

            def _route(self, path: str, qs):
                if path == "/api/separate" and outer.separation:
                    wav, _ = decode_wav(self._body())
                    est = outer.separation.process(
                        wav,
                        n_steps=_q1(qs, "n_steps", int, 30),
                        snr=_q1(qs, "snr", float, 0.5),
                        corrector_steps=_q1(qs, "corrector_steps", int, 1),
                        seed=_q1(qs, "seed", int, 0))
                    fs = outer.separation.fs
                    self._json({"fs": fs, "sources": [
                        base64.b64encode(encode_wav(s, fs)).decode()
                        for s in est]})
                elif path == "/api/autoencoder" and outer.autoencoder:
                    wav, _ = decode_wav(self._body())
                    rec = outer.autoencoder.process(
                        wav,
                        latent_noise=_q1(qs, "latent_noise", float, 0.0),
                        seed=_q1(qs, "seed", int, 0))
                    self._send(200, encode_wav(rec, outer.autoencoder.fs),
                               "audio/wav")
                elif path == "/api/generate" and outer.generation:
                    kw = json.loads(self._body() or b"{}")
                    audio = outer.generation.generate_uncond(
                        steps=int(kw.get("steps", 50)),
                        seed=int(kw.get("seed", 0)),
                        sigma_min=float(kw.get("sigma_min", 0.3)),
                        sigma_max=float(kw.get("sigma_max", 50.0)))
                    self._send(200, encode_wav(audio[0],
                                               outer.generation.fs),
                               "audio/wav")
                elif (path == "/api/generate_cond" and outer.generation
                        and outer.generation.routing is not None):
                    kw = json.loads(self._body() or b"{}")
                    cond = outer._cond_inputs(kw.get("cond", {}))
                    audio = outer.generation.generate_conditional(
                        cond, steps=int(kw.get("steps", 50)),
                        cfg_scale=float(kw.get("cfg_scale", 6.0)),
                        seed=int(kw.get("seed", 0)))
                    self._send(200, encode_wav(audio[0],
                                               outer.generation.fs),
                               "audio/wav")
                elif path == "/api/lm" and outer.lm:
                    kw = json.loads(self._body() or b"{}")
                    out = outer.lm.process(
                        length=int(kw.get("length", 64)),
                        temperature=float(kw.get("temperature", 1.0)),
                        top_k=int(kw.get("top_k", 250)),
                        top_p=float(kw.get("top_p", 0.0)),
                        seed=int(kw.get("seed", 0)))
                    if outer.lm.decode_tokens is None:
                        self._json({"codes": np.asarray(out).tolist()})
                    else:
                        self._send(200,
                                   encode_wav(np.asarray(out).reshape(-1),
                                              outer.lm.fs), "audio/wav")
                else:
                    self._fail("no such endpoint (backend not loaded)",
                               404)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    # -- conditioner input marshalling -------------------------------------
    @staticmethod
    def _cond_inputs(cond: Dict[str, Any]) -> Dict[str, Any]:
        """JSON condition dict -> conditioner inputs: numbers become
        (B=1,) float arrays (NumberConditioner contract), strings and
        lists-of-strings pass through (text/phoneme conditioners)."""
        out: Dict[str, Any] = {}
        for k, v in cond.items():
            if isinstance(v, (int, float)):
                out[k] = np.asarray([v], np.float32)
            elif (isinstance(v, list)
                    and v and isinstance(v[0], (int, float))):
                out[k] = np.asarray(v, np.float32)
            else:
                out[k] = v
        return out

    def info(self) -> Dict[str, Any]:
        return {
            "separation": bool(self.separation),
            "autoencoder": bool(self.autoencoder),
            "generation": bool(self.generation),
            "generation_cond": bool(
                self.generation is not None
                and self.generation.routing is not None),
            "lm": bool(self.lm),
            "fs": next((b.fs for b in (self.separation, self.autoencoder,
                                       self.generation, self.lm)
                        if b is not None), 8000),
        }

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def serve_forever(self):
        print(f"ditsep_tpu_torch demo listening on "
              f"http://{self._httpd.server_address[0]}:{self.port}",
              flush=True)
        self._httpd.serve_forever()

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
