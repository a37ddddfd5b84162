"""Tkinter desktop application.

Counterpart of ``hifigan_tpu/app/desktop.py``: language boxes and a switch
button, source and target text panes, record / translate / play controls,
a Tools menu (download models, offline check, history, clear cache) and a
``queue.Queue`` pump for UI updates from worker threads.  Recording is
simulated (a server has no audio device); playback writes a temporary WAV
and opens it with the platform's handler.  ``tkinter`` is imported when
the window is built.
"""

from __future__ import annotations

import queue
import tempfile
import threading
import webbrowser
from typing import Optional

import numpy as np

from hifigan_tpu_torch.app.audio import float_to_wav_bytes
from hifigan_tpu_torch.app.engine import RealTimeTranslationEngine
from hifigan_tpu_torch.app.offline import offline_manager


class VoiceTranslationDesktopApp:
    LANGS = ("en", "es", "fr", "de")

    def __init__(self, engine: Optional[RealTimeTranslationEngine] = None):
        import tkinter as tk
        from tkinter import scrolledtext, ttk

        self.tk = tk
        self.engine = engine or RealTimeTranslationEngine()
        self.ui_queue: "queue.Queue" = queue.Queue()

        self.root = tk.Tk()
        self.root.title("hifigan-tpu-torch voice translator")

        top = ttk.Frame(self.root, padding=8)
        top.pack(fill="x")
        self.src_lang = ttk.Combobox(top, values=self.LANGS, width=5)
        self.src_lang.set(self.engine.source_lang)
        self.src_lang.pack(side="left")
        ttk.Button(top, text="⇄", command=self.switch_languages).pack(side="left")
        self.tgt_lang = ttk.Combobox(top, values=self.LANGS, width=5)
        self.tgt_lang.set(self.engine.target_lang)
        self.tgt_lang.pack(side="left")

        self.source_pane = scrolledtext.ScrolledText(self.root, height=6)
        self.source_pane.pack(fill="both", expand=True, padx=8)
        self.target_pane = scrolledtext.ScrolledText(self.root, height=6)
        self.target_pane.pack(fill="both", expand=True, padx=8)

        controls = ttk.Frame(self.root, padding=8)
        controls.pack(fill="x")
        self.record_btn = ttk.Button(controls, text="Record", command=self.toggle_record)
        self.record_btn.pack(side="left")
        ttk.Button(controls, text="Translate", command=self.translate).pack(side="left")
        ttk.Button(controls, text="Play", command=self.play).pack(side="left")
        self.status = ttk.Label(controls, text="ready")
        self.status.pack(side="right")

        menubar = tk.Menu(self.root)
        tools = tk.Menu(menubar, tearoff=0)
        tools.add_command(label="Download models", command=self.download_models)
        tools.add_command(label="Check offline capability", command=self.check_offline)
        tools.add_command(label="Show history", command=self.show_history)
        tools.add_command(label="Clear cache", command=self.clear_cache)
        menubar.add_cascade(label="Tools", menu=tools)
        self.root.config(menu=menubar)

        self._recording = False
        self._last_audio: Optional[np.ndarray] = None
        self.root.after(100, self._pump)

    # ---- UI pump (thread-safe updates) ----

    def _pump(self):
        try:
            while True:
                fn = self.ui_queue.get_nowait()
                fn()
        except queue.Empty:
            pass
        self.root.after(100, self._pump)

    def _set_status(self, text: str):
        self.ui_queue.put(lambda: self.status.config(text=text))

    # ---- actions ----

    def toggle_record(self):
        self._recording = not self._recording
        self.record_btn.config(text="Stop" if self._recording else "Record")
        self._set_status("recording (no input device: simulated)" if self._recording
                         else "ready")

    def translate(self):
        text = self.source_pane.get("1.0", "end").strip()

        def work():
            result = self.engine.translate_text(text)
            self._last_audio = None
            offline_manager.save_translation(
                result.source_text, result.translated_text,
                result.source_lang, result.target_lang,
            )
            self.ui_queue.put(lambda: (
                self.target_pane.delete("1.0", "end"),
                self.target_pane.insert("1.0", result.translated_text),
            ))
            self._set_status(f"translated in {result.processing_time:.2f}s")

        threading.Thread(target=work, daemon=True).start()

    def play(self):
        text = self.target_pane.get("1.0", "end").strip()

        def work():
            result = self.engine.synthesize_text(text)
            if result.audio is not None and result.audio.size:
                with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
                    f.write(float_to_wav_bytes(result.audio))
                    webbrowser.open("file://" + f.name)
                self._set_status("playing")
            else:
                self._set_status("no audio (TTS unavailable)")

        threading.Thread(target=work, daemon=True).start()

    def switch_languages(self):
        def work():
            self.engine.switch_languages()
            self.ui_queue.put(lambda: (
                self.src_lang.set(self.engine.source_lang),
                self.tgt_lang.set(self.engine.target_lang),
            ))
            self._set_status("languages switched")

        threading.Thread(target=work, daemon=True).start()

    def download_models(self):
        def work():
            self._set_status("downloading models…")
            ok = all(offline_manager.download_model(mt)
                     for mt in offline_manager.registry)
            self._set_status("downloads complete" if ok else "some downloads failed")

        threading.Thread(target=work, daemon=True).start()

    def check_offline(self):
        from tkinter import messagebox

        cap = offline_manager.check_offline_capability()
        messagebox.showinfo("Offline capability", str(cap))

    def show_history(self):
        from tkinter import messagebox

        history = offline_manager.load_history()[-10:]
        lines = [f"{h['source_text']} → {h['translated_text']}" for h in history]
        messagebox.showinfo("History (last 10)", "\n".join(lines) or "empty")

    def clear_cache(self):
        offline_manager.clear_cache()
        self._set_status("cache cleared")

    def run(self):
        self.root.mainloop()


def main():
    VoiceTranslationDesktopApp().run()


if __name__ == "__main__":
    main()
