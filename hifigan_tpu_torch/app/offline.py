"""Offline model manager: registry, availability checks, downloads,
translation history and cache management.

Counterpart of ``hifigan_tpu/app/offline.py``, with its history file format
(a JSON list of ``{timestamp, source_text, translated_text, source_lang,
target_lang}``, capped at 1000 entries).  The base directory is named after
the port (``~/.hifigan_tpu_torch``) and is created at the first write, not
when the module is imported; the vocoder's local copy is a directory of the
port's ``<step>.pt`` train states.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, Optional


MODEL_REGISTRY = {
    "asr": {
        "name": "facebook/wav2vec2-large-960h-lv60-self",
        "local_path": "models/asr",
        "approx_size_mb": 1200,
    },
    "translation": {
        "name": "Helsinki-NLP/opus-mt-en-es",
        "local_path": "models/translation",
        "approx_size_mb": 300,
    },
    "tts": {
        "name": "microsoft/speecht5_tts",
        "local_path": "models/tts",
        "approx_size_mb": 600,
    },
    "vocoder": {
        "name": "hifigan_tpu_torch-generator",
        "local_path": "models/vocoder",
        "approx_size_mb": 60,
    },
}


class OfflineManager:
    def __init__(self, base_dir: str = "~/.hifigan_tpu_torch", registry: Optional[dict] = None):
        self.base_dir = os.path.expanduser(base_dir)
        self.registry = registry or {k: dict(v) for k, v in MODEL_REGISTRY.items()}
        self.history_path = os.path.join(self.base_dir, "translation_history.json")

    # ---- availability ----

    def model_path(self, model_type: str) -> str:
        return os.path.join(self.base_dir, self.registry[model_type]["local_path"])

    def is_model_available(self, model_type: str) -> bool:
        """The vocoder: its directory holds a file; an HF model: its
        ``config.json`` is present."""
        path = self.model_path(model_type)
        if not os.path.isdir(path):
            return False
        if model_type == "vocoder":
            return any(os.scandir(path))
        return os.path.exists(os.path.join(path, "config.json"))

    def download_model(self, model_type: str) -> bool:
        """Snapshot an HF model into the local cache (network required)."""
        spec = self.registry[model_type]
        path = self.model_path(model_type)
        os.makedirs(path, exist_ok=True)
        try:
            from huggingface_hub import snapshot_download

            snapshot_download(spec["name"], local_dir=path)
            return True
        except Exception:
            return False

    # ---- history ----

    def save_translation(self, source: str, translated: str,
                         source_lang: str, target_lang: str,
                         max_entries: int = 1000):
        history = self.load_history()
        history.append({
            "timestamp": time.time(),
            "source_text": source,
            "translated_text": translated,
            "source_lang": source_lang,
            "target_lang": target_lang,
        })
        history = history[-max_entries:]
        os.makedirs(self.base_dir, exist_ok=True)
        with open(self.history_path, "w") as f:
            json.dump(history, f, indent=2)

    def load_history(self) -> list:
        if not os.path.exists(self.history_path):
            return []
        try:
            with open(self.history_path) as f:
                return json.load(f)
        except Exception:
            return []

    def clear_history(self):
        if os.path.exists(self.history_path):
            os.remove(self.history_path)

    # ---- cache ----

    def cache_size_mb(self) -> float:
        total = 0
        for root, _, files in os.walk(self.base_dir):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(root, name))
                except OSError:
                    pass
        return total / 1e6

    def clear_cache(self, model_type: Optional[str] = None):
        if model_type:
            shutil.rmtree(self.model_path(model_type), ignore_errors=True)
        else:
            for mt in self.registry:
                shutil.rmtree(self.model_path(mt), ignore_errors=True)

    # ---- summary ----

    def check_offline_capability(self) -> Dict:
        status = {mt: self.is_model_available(mt) for mt in self.registry}
        return {
            "models": status,
            "fully_offline": all(status.values()),
            "cache_size_mb": self.cache_size_mb(),
            "history_entries": len(self.load_history()),
        }


offline_manager = OfflineManager()
