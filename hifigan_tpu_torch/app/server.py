"""Web server of the real-time translation app.

Counterpart of ``hifigan_tpu/app/server.py``: REST routes ``/`` (the web
client), ``/static/*``, ``/api/health``, ``/api/models/info``,
``/api/translate/text``, ``/api/synthesize/text`` (a base64 WAV reply),
and, in two backends:

* :func:`create_fastapi_app`: also the WebSocket ``/ws/translate/{client_id}``
  (``audio_chunk``, ``text_translate``, ``switch_languages``, ``ping``);
  needs fastapi and uvicorn, imported when called;
* :class:`StdlibServer`: ``http.server`` only, with ``POST
  /api/stream/chunk`` and ``POST /api/switch_languages`` in the WebSocket's
  place.

Translations are recorded in an :class:`~hifigan_tpu_torch.app.offline.OfflineManager`'s
history (the module's ``offline_manager`` unless one is given).
"""

from __future__ import annotations

import base64
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import torch

from hifigan_tpu_torch.app.audio import float_to_wav_bytes, wav_bytes_to_float
from hifigan_tpu_torch.app.config import Settings, settings as default_settings
from hifigan_tpu_torch.app.engine import RealTimeTranslationEngine
from hifigan_tpu_torch.app.offline import OfflineManager, offline_manager

log = logging.getLogger(__name__)

STATIC_DIR = Path(__file__).resolve().parent / "static"
_STATIC_TYPES = {".html": "text/html", ".js": "text/javascript",
                 ".css": "text/css", ".ico": "image/x-icon"}


def _static_file(name: str) -> tuple[bytes, str] | None:
    """Resolve a /static/* request to (bytes, content-type) or None: the
    bundled web client (WebSocket client, microphone capture, base64 audio
    exchange, history)."""
    path = (STATIC_DIR / name).resolve()
    if not path.is_relative_to(STATIC_DIR) or not path.is_file():
        return None
    ctype = _STATIC_TYPES.get(path.suffix)
    if ctype is None:
        return None
    return path.read_bytes(), ctype


def _handle_text_translate(engine, payload: dict, offline: OfflineManager) -> dict:
    result = engine.translate_text(payload.get("text", ""))
    offline.save_translation(
        result.source_text, result.translated_text,
        result.source_lang, result.target_lang,
    )
    return {
        "source_text": result.source_text,
        "translated_text": result.translated_text,
        "source_lang": result.source_lang,
        "target_lang": result.target_lang,
        "processing_time": result.processing_time,
    }


def _handle_synthesize(engine, payload: dict) -> dict:
    result = engine.synthesize_text(payload.get("text", ""))
    audio_b64 = ""
    if result.audio is not None and result.audio.size:
        audio_b64 = base64.b64encode(float_to_wav_bytes(result.audio)).decode()
    return {"audio": audio_b64, "processing_time": result.processing_time}


def _handle_audio_chunk(engine, payload: dict) -> dict:
    raw = base64.b64decode(payload.get("audio", ""))
    audio, sr = wav_bytes_to_float(raw)
    result = engine.process_streaming_audio(audio)
    reply = {
        "type": "translation_update",
        "source_text": result.source_text,
        "translated_text": result.translated_text,
    }
    if result.audio is not None and result.audio.size:
        reply["audio"] = base64.b64encode(float_to_wav_bytes(result.audio)).decode()
    return reply


def _models_info(engine, offline: OfflineManager) -> dict:
    return {
        "engine": engine.get_model_info(),
        "offline": offline.check_offline_capability(),
    }


# --------------------------------------------------------------------------
# FastAPI backend (gated)
# --------------------------------------------------------------------------


def create_fastapi_app(engine: Optional[RealTimeTranslationEngine] = None,
                       cfg: Settings = default_settings, offline: OfflineManager = offline_manager,
                       device: str | torch.device = "cuda"):
    """Build the FastAPI app (raises ImportError without fastapi); without
    ``engine``, it builds one on ``device``."""
    from fastapi import FastAPI, WebSocket, WebSocketDisconnect
    from fastapi.middleware.cors import CORSMiddleware
    from fastapi.responses import HTMLResponse

    app = FastAPI(title=cfg.app_name, version=cfg.version)
    app.add_middleware(
        CORSMiddleware, allow_origins=list(cfg.web.cors_origins),
        allow_methods=["*"], allow_headers=["*"],
    )
    eng = engine or RealTimeTranslationEngine(
        cfg.translation.source_lang, cfg.translation.target_lang,
        vocoder_checkpoint=cfg.models.vocoder_checkpoint, device=device,
    )

    class ConnectionManager:
        def __init__(self):
            self.active: dict = {}

        async def connect(self, client_id: str, ws: WebSocket):
            await ws.accept()
            self.active[client_id] = ws

        def disconnect(self, client_id: str):
            self.active.pop(client_id, None)

    manager = ConnectionManager()

    @app.get("/", response_class=HTMLResponse)
    def index():
        hit = _static_file("index.html")
        return hit[0].decode() if hit else INDEX_HTML

    @app.get("/static/{name:path}")
    def static(name: str):
        from fastapi import HTTPException
        from fastapi.responses import Response

        hit = _static_file(name)
        if hit is None:
            raise HTTPException(404)
        return Response(content=hit[0], media_type=hit[1])

    @app.get("/api/health")
    def health():
        return {"status": "ok", "app": cfg.app_name, "version": cfg.version}

    @app.get("/api/models/info")
    def models_info():
        return _models_info(eng, offline)

    @app.post("/api/translate/text")
    def translate_text(payload: dict):
        return _handle_text_translate(eng, payload, offline)

    @app.post("/api/synthesize/text")
    def synthesize_text(payload: dict):
        return _handle_synthesize(eng, payload)

    @app.websocket("/ws/translate/{client_id}")
    async def ws_translate(ws: WebSocket, client_id: str):
        await manager.connect(client_id, ws)
        try:
            while True:
                msg = json.loads(await ws.receive_text())
                kind = msg.get("type")
                if kind == "audio_chunk":
                    await ws.send_json(_handle_audio_chunk(eng, msg))
                elif kind == "text_translate":
                    await ws.send_json(
                        {"type": "translation_update", **_handle_text_translate(eng, msg, offline)}
                    )
                elif kind == "switch_languages":
                    eng.switch_languages()
                    await ws.send_json({"type": "languages_switched",
                                        "source_lang": eng.source_lang,
                                        "target_lang": eng.target_lang})
                elif kind == "ping":
                    await ws.send_json({"type": "pong"})
                else:
                    await ws.send_json({"type": "error",
                                        "message": f"unknown type {kind!r}"})
        except WebSocketDisconnect:
            manager.disconnect(client_id)

    return app


# --------------------------------------------------------------------------
# stdlib backend
# --------------------------------------------------------------------------


class StdlibServer:
    """Dependency-free REST server over ``http.server``; without ``engine``,
    it builds one on ``device``."""

    def __init__(self, engine: Optional[RealTimeTranslationEngine] = None,
                 cfg: Settings = default_settings, *, load_models: bool = True,
                 offline: OfflineManager = offline_manager, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.offline = offline
        self.engine = engine or RealTimeTranslationEngine(
            cfg.translation.source_lang, cfg.translation.target_lang,
            load_models=load_models,
            vocoder_checkpoint=cfg.models.vocoder_checkpoint, device=device,
        )
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _make_handler(self):
        engine, cfg, offline = self.engine, self.cfg, self.offline

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, obj, code=200, content_type="application/json"):
                body = (json.dumps(obj) if content_type == "application/json"
                        else obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Access-Control-Allow-Origin", "*")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/api/health":
                    self._send({"status": "ok", "app": cfg.app_name,
                                "version": cfg.version})
                elif self.path == "/api/models/info":
                    self._send(_models_info(engine, offline))
                elif self.path == "/":
                    hit = _static_file("index.html")
                    body = hit[0].decode() if hit else INDEX_HTML
                    self._send(body, content_type="text/html")
                elif self.path.startswith("/static/"):
                    hit = _static_file(self.path[len("/static/"):])
                    if hit is None:
                        self._send({"error": "not found"}, 404)
                    else:
                        self._send(hit[0].decode(), content_type=hit[1])
                else:
                    self._send({"error": "not found"}, 404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    return self._send({"error": "invalid JSON body"}, 400)
                try:
                    if self.path == "/api/translate/text":
                        self._send(_handle_text_translate(engine, payload, offline))
                    elif self.path == "/api/synthesize/text":
                        self._send(_handle_synthesize(engine, payload))
                    elif self.path == "/api/stream/chunk":
                        self._send(_handle_audio_chunk(engine, payload))
                    elif self.path == "/api/switch_languages":
                        engine.switch_languages()
                        self._send({"source_lang": engine.source_lang,
                                    "target_lang": engine.target_lang})
                    else:
                        self._send({"error": "not found"}, 404)
                except Exception as e:
                    log.exception("request failed")
                    self._send({"error": str(e)}, 500)

        return Handler

    def start(self, *, background: bool = True) -> int:
        """Bind ``cfg.web``'s host and port (0: a free port) and serve, in a
        daemon thread when ``background``; returns the bound port."""
        self._httpd = ThreadingHTTPServer(
            (self.cfg.web.host, self.cfg.web.port), self._make_handler()
        )
        port = self._httpd.server_address[1]
        if background:
            self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
        else:
            self._httpd.serve_forever()
        return port

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()


def serve(cfg: Settings = default_settings, device: str | torch.device = "cuda"):
    """Entry point: FastAPI+uvicorn when available, stdlib otherwise; the
    engine runs on ``device``."""
    try:
        import uvicorn

        app = create_fastapi_app(cfg=cfg, device=device)
        uvicorn.run(app, host=cfg.web.host, port=cfg.web.port)
    except ImportError:
        log.warning("fastapi/uvicorn unavailable; using stdlib HTTP server")
        StdlibServer(cfg=cfg, device=device).start(background=False)


INDEX_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>hifigan-tpu translator</title>
<style>
body{font-family:system-ui;margin:2rem auto;max-width:640px;color:#222}
textarea{width:100%;height:5rem} button{padding:.5rem 1rem;margin:.25rem}
.out{white-space:pre-wrap;background:#f4f4f4;padding:1rem;border-radius:8px}
</style></head><body>
<h1>Real-time voice translator</h1>
<p>Expressive voice-cloning vocoder framework demo.</p>
<textarea id="src" placeholder="Type text to translate…"></textarea><br>
<button onclick="translateText()">Translate</button>
<button onclick="synthesize()">Synthesize</button>
<div class="out" id="out"></div><audio id="player" controls></audio>
<script>
async function post(path, body){
  const r = await fetch(path,{method:'POST',headers:{'Content-Type':'application/json'},
    body:JSON.stringify(body)});
  return r.json();
}
async function translateText(){
  const res = await post('/api/translate/text',{text:document.getElementById('src').value});
  document.getElementById('out').textContent = JSON.stringify(res,null,2);
}
async function synthesize(){
  const res = await post('/api/synthesize/text',{text:document.getElementById('src').value});
  if(res.audio){document.getElementById('player').src='data:audio/wav;base64,'+res.audio;}
  document.getElementById('out').textContent='synthesized in '+res.processing_time.toFixed(2)+'s';
}
</script></body></html>
"""
