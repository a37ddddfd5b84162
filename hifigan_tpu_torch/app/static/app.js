/*
 * TranslatorClient — browser client for the hifigan-tpu translation server.
 *
 * The port's copy of hifigan_tpu/app/static/app.js: WebSocket, mic
 * capture, base64 audio exchange and history.
 *   - audio is captured as raw PCM through the Web Audio API and packed
 *     into 16-bit WAV in-browser, so the server's dependency-free WAV
 *     decoder (app/audio.py wav_bytes_to_float) can read every chunk —
 *     no MediaRecorder/webm/opus server-side decode needed;
 *   - transport is negotiated: native WebSocket (/ws/translate/{id})
 *     when the backend supports it, otherwise REST
 *     (POST /api/stream/chunk) against the stdlib server;
 *   - history persists in localStorage.
 */
"use strict";

const $ = (id) => document.getElementById(id);

/* ---------------- WAV packing (PCM float32 -> 16-bit WAV) ---------------- */

function floatTo16BitWav(samples, sampleRate) {
  const buf = new ArrayBuffer(44 + samples.length * 2);
  const v = new DataView(buf);
  const str = (off, s) => { for (let i = 0; i < s.length; i++) v.setUint8(off + i, s.charCodeAt(i)); };
  str(0, "RIFF"); v.setUint32(4, 36 + samples.length * 2, true); str(8, "WAVE");
  str(12, "fmt "); v.setUint32(16, 16, true); v.setUint16(20, 1, true);
  v.setUint16(22, 1, true); v.setUint32(24, sampleRate, true);
  v.setUint32(28, sampleRate * 2, true); v.setUint16(32, 2, true); v.setUint16(34, 16, true);
  str(36, "data"); v.setUint32(40, samples.length * 2, true);
  for (let i = 0; i < samples.length; i++) {
    const s = Math.max(-1, Math.min(1, samples[i]));
    v.setInt16(44 + i * 2, s < 0 ? s * 0x8000 : s * 0x7fff, true);
  }
  return buf;
}

function bufToB64(buf) {
  const bytes = new Uint8Array(buf);
  let s = "";
  for (let i = 0; i < bytes.length; i += 0x8000)
    s += String.fromCharCode.apply(null, bytes.subarray(i, i + 0x8000));
  return btoa(s);
}

/* ---------------------------- client ---------------------------- */

class TranslatorClient {
  constructor() {
    this.clientId = Math.random().toString(36).slice(2, 10);
    this.ws = null;
    this.wsOk = false;        // websocket handshake succeeded at least once
    this.restMode = false;    // fall back to POST /api/stream/chunk
    this.audioCtx = null;
    this.captureNode = null;
    this.stream = null;
    this.recording = false;
    this.pcmQueue = [];       // Float32Array chunks pending send
    this.queuedSamples = 0;
    this.chunkSamples = 0;    // set from sampleRate: ~0.5 s per send
    this.pingT0 = 0;
    this.history = this.loadHistory();

    this.bindUi();
    this.renderHistory();
    this.connect();
    setInterval(() => this.ping(), 10000);
  }

  /* ---- transport ---- */

  connect() {
    const proto = location.protocol === "https:" ? "wss" : "ws";
    try {
      this.ws = new WebSocket(`${proto}://${location.host}/ws/translate/${this.clientId}`);
    } catch (e) {
      this.enterRestMode();
      return;
    }
    this.ws.onopen = () => {
      this.wsOk = true;
      this.restMode = false;
      this.setStatus("connected", true);
    };
    this.ws.onmessage = (ev) => this.onMessage(JSON.parse(ev.data));
    this.ws.onclose = () => {
      this.setStatus("disconnected", false);
      if (this.wsOk) setTimeout(() => this.connect(), 3000);
      else this.enterRestMode();  // backend has no WS — use REST
    };
    this.ws.onerror = () => {};
  }

  enterRestMode() {
    this.restMode = true;
    fetch("/api/health").then((r) => r.json())
      .then(() => this.setStatus("connected (REST)", true))
      .catch(() => {
        this.setStatus("offline", false);
        setTimeout(() => this.connect(), 5000);
      });
  }

  /** Send a message; resolves with the reply (REST) or null (WS: reply
   *  arrives via onmessage). */
  async send(msg) {
    if (!this.restMode && this.ws && this.ws.readyState === WebSocket.OPEN) {
      this.ws.send(JSON.stringify(msg));
      return null;
    }
    const routes = {
      audio_chunk: "/api/stream/chunk",
      text_translate: "/api/translate/text",
      switch_languages: "/api/switch_languages",
    };
    const path = routes[msg.type];
    if (!path) return null;
    const r = await fetch(path, {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify(msg),
    });
    const reply = await r.json();
    if (msg.type === "text_translate") reply.type = "translation_update";
    if (msg.type === "switch_languages") reply.type = "languages_switched";
    this.onMessage(reply);
    return reply;
  }

  ping() {
    this.pingT0 = performance.now();
    if (!this.restMode && this.ws && this.ws.readyState === WebSocket.OPEN) {
      this.ws.send(JSON.stringify({ type: "ping" }));
    } else {
      fetch("/api/health").then(() => this.showLatency()).catch(() => {});
    }
  }

  showLatency() {
    $("latency").textContent = `${Math.round(performance.now() - this.pingT0)} ms`;
  }

  /* ---- message handling ---- */

  onMessage(msg) {
    switch (msg.type) {
      case "translation_update": {
        if (msg.source_text) $("srcText").value = msg.source_text;
        if (msg.translated_text) $("tgtText").textContent = msg.translated_text;
        if (msg.audio) this.playB64Wav(msg.audio);
        if (msg.translated_text)
          this.pushHistory(msg.source_text || $("srcText").value, msg.translated_text);
        break;
      }
      case "languages_switched": {
        if (msg.source_lang) $("srcLang").value = msg.source_lang;
        if (msg.target_lang) $("tgtLang").value = msg.target_lang;
        this.toast(`languages: ${msg.source_lang} → ${msg.target_lang}`);
        break;
      }
      case "pong":
        this.showLatency();
        break;
      case "error":
        this.toast(msg.message || "server error", true);
        break;
    }
  }

  playB64Wav(b64) {
    const player = $("player");
    player.src = "data:audio/wav;base64," + b64;
    player.play().catch(() => {});  // autoplay policies: leave it loaded
  }

  /* ---- microphone capture ---- */

  async startRecording() {
    try {
      this.stream = await navigator.mediaDevices.getUserMedia({
        audio: { channelCount: 1, echoCancellation: true, noiseSuppression: true },
      });
    } catch (e) {
      this.toast("microphone access denied", true);
      return;
    }
    this.audioCtx = new (window.AudioContext || window.webkitAudioContext)();
    this.chunkSamples = Math.round(this.audioCtx.sampleRate * 0.5);
    const src = this.audioCtx.createMediaStreamSource(this.stream);
    // ScriptProcessor: deprecated but universal; 4096-sample blocks.
    this.captureNode = this.audioCtx.createScriptProcessor(4096, 1, 1);
    this.captureNode.onaudioprocess = (ev) => {
      if (!this.recording) return;
      const block = new Float32Array(ev.inputBuffer.getChannelData(0));
      this.pcmQueue.push(block);
      this.queuedSamples += block.length;
      this.updateVu(block);
      if (this.queuedSamples >= this.chunkSamples) this.flushAudio();
    };
    src.connect(this.captureNode);
    this.captureNode.connect(this.audioCtx.destination);
    this.recording = true;
    $("recBtn").textContent = "■ Stop";
    $("recBtn").classList.add("live");
  }

  stopRecording() {
    this.recording = false;
    this.flushAudio();
    if (this.captureNode) this.captureNode.disconnect();
    if (this.stream) this.stream.getTracks().forEach((t) => t.stop());
    if (this.audioCtx) this.audioCtx.close();
    this.captureNode = this.audioCtx = this.stream = null;
    $("recBtn").textContent = "● Record";
    $("recBtn").classList.remove("live");
    $("vuFill").style.width = "0";
  }

  flushAudio() {
    if (!this.queuedSamples) return;
    const all = new Float32Array(this.queuedSamples);
    let off = 0;
    for (const b of this.pcmQueue) { all.set(b, off); off += b.length; }
    this.pcmQueue = [];
    this.queuedSamples = 0;
    if (!$("liveMode").checked && this.recording) return;  // batch mode: send on stop
    const wav = floatTo16BitWav(all, this.audioCtx ? this.audioCtx.sampleRate : 16000);
    this.send({ type: "audio_chunk", audio: bufToB64(wav) });
  }

  updateVu(block) {
    let peak = 0;
    for (let i = 0; i < block.length; i += 16) peak = Math.max(peak, Math.abs(block[i]));
    $("vuFill").style.width = Math.min(100, peak * 140) + "%";
  }

  /* ---- history ---- */

  loadHistory() {
    try { return JSON.parse(localStorage.getItem("tr_history") || "[]"); }
    catch (e) { return []; }
  }

  pushHistory(srcText, tgtText) {
    this.history.unshift({
      src: srcText, tgt: tgtText,
      langs: `${$("srcLang").value} → ${$("tgtLang").value}`,
      t: new Date().toISOString(),
    });
    this.history = this.history.slice(0, 50);
    localStorage.setItem("tr_history", JSON.stringify(this.history));
    this.renderHistory();
  }

  renderHistory() {
    const list = $("historyList");
    list.textContent = "";
    for (const item of this.history) {
      const div = document.createElement("div");
      div.className = "history-item";
      const head = document.createElement("div");
      head.className = "history-head";
      head.textContent = `${item.langs} · ${new Date(item.t).toLocaleTimeString()}`;
      const src = document.createElement("div");
      src.className = "history-src";
      src.textContent = item.src;
      const tgt = document.createElement("div");
      tgt.className = "history-tgt";
      tgt.textContent = item.tgt;
      div.append(head, src, tgt);
      list.appendChild(div);
    }
  }

  /* ---- UI ---- */

  bindUi() {
    $("recBtn").onclick = () => (this.recording ? this.stopRecording() : this.startRecording());
    $("translateBtn").onclick = () =>
      this.send({ type: "text_translate", text: $("srcText").value });
    $("synthBtn").onclick = async () => {
      const r = await fetch("/api/synthesize/text", {
        method: "POST",
        headers: { "Content-Type": "application/json" },
        body: JSON.stringify({ text: $("srcText").value }),
      });
      const res = await r.json();
      if (res.audio) this.playB64Wav(res.audio);
      this.toast(`synthesized in ${(res.processing_time || 0).toFixed(2)} s`);
    };
    $("swapBtn").onclick = () => {
      const a = $("srcLang").value;
      $("srcLang").value = $("tgtLang").value;
      $("tgtLang").value = a;
      this.send({ type: "switch_languages" });
    };
    $("clearSrc").onclick = () => { $("srcText").value = ""; };
    $("copySrc").onclick = () => navigator.clipboard.writeText($("srcText").value);
    $("copyTgt").onclick = () => navigator.clipboard.writeText($("tgtText").textContent);
    $("playTgt").onclick = () => $("player").play();
    $("clearHistory").onclick = () => {
      this.history = [];
      localStorage.removeItem("tr_history");
      this.renderHistory();
    };
    let debounce = null;
    $("srcText").addEventListener("input", () => {
      if (!$("liveMode").checked) return;
      clearTimeout(debounce);
      debounce = setTimeout(
        () => this.send({ type: "text_translate", text: $("srcText").value }), 600);
    });
  }

  setStatus(text, ok) {
    const el = $("connStatus");
    el.textContent = text;
    el.className = "badge " + (ok ? "on" : "off");
  }

  toast(text, isErr) {
    const el = $("toast");
    el.textContent = text;
    el.className = "toast" + (isErr ? " err" : "");
    clearTimeout(this._toastT);
    this._toastT = setTimeout(() => el.classList.add("hidden"), 3500);
  }
}

window.addEventListener("DOMContentLoaded", () => {
  window.client = new TranslatorClient();
});
