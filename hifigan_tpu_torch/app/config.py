"""Application configuration.

Counterpart of ``hifigan_tpu/app/config.py``: the audio, model,
translation and web settings merged into one :class:`Settings` with flat
environment overrides (``HIFIGAN_TPU_<FIELD>``, the JAX package's prefix),
read from a **JSON** file with the keys of the JAX package's YAML file (the
card's machine has no ``yaml``):

    {"web": {"port": 8000}, "models": {"vocoder_checkpoint": "ckpt"}}

The device is not a setting: ``serve``, ``StdlibServer`` and
``create_fastapi_app`` take it (``cli serve --device``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, Optional


@dataclass
class AudioSettings:
    sample_rate: int = 16_000
    channels: int = 1
    chunk_size: int = 1024
    format: str = "int16"
    max_duration_s: float = 30.0


@dataclass
class ModelSettings:
    # HF checkpoints per stage
    asr_model: str = "facebook/wav2vec2-large-960h-lv60-self"
    mt_model_en_es: str = "Helsinki-NLP/opus-mt-en-es"
    mt_model_es_en: str = "Helsinki-NLP/opus-mt-es-en"
    tts_model: str = "microsoft/speecht5_tts"
    vocoder_checkpoint: Optional[str] = None  # a directory of the port's <step>.pt train states
    use_tpu: bool = True  # the JAX package's key, kept so that its files read the same; unused


@dataclass
class TranslationSettings:
    source_lang: str = "en"
    target_lang: str = "es"
    beam_size: int = 5
    no_repeat_ngram: int = 2
    streaming_asr_buffer: int = 5
    streaming_mt_buffer: int = 3
    streaming_tts_buffer: int = 2


@dataclass
class WebSettings:
    host: str = "127.0.0.1"
    port: int = 8000
    cors_origins: tuple = ("*",)


SECTIONS = ("audio", "models", "translation", "web")


@dataclass
class Settings:
    app_name: str = "hifigan-tpu-translator"
    version: str = "0.1.0"
    audio: AudioSettings = field(default_factory=AudioSettings)
    models: ModelSettings = field(default_factory=ModelSettings)
    translation: TranslationSettings = field(default_factory=TranslationSettings)
    web: WebSettings = field(default_factory=WebSettings)

    def with_env_overrides(self, prefix: str = "HIFIGAN_TPU_") -> "Settings":
        """Flat env overrides: HIFIGAN_TPU_PORT, HIFIGAN_TPU_SOURCE_LANG, …"""
        out = self
        for section_name in SECTIONS:
            section = getattr(out, section_name)
            updates = {}
            for f in fields(section):
                env = os.environ.get(prefix + f.name.upper())
                if env is not None:
                    cur = getattr(section, f.name)
                    if isinstance(cur, bool):
                        updates[f.name] = env.lower() in ("1", "true", "yes")
                    elif isinstance(cur, int):
                        updates[f.name] = int(env)
                    elif isinstance(cur, float):
                        updates[f.name] = float(env)
                    else:
                        updates[f.name] = env
            if updates:
                out = replace(out, **{section_name: replace(section, **updates)})
        return out


def load_config(path: str) -> Dict[str, Any]:
    """Read a JSON config file; a YAML path raises ``ValueError``."""
    if path.lower().endswith((".yaml", ".yml")):
        raise ValueError(f"{path}: the port reads JSON config files, not YAML (the yaml package is not one of "
                         'its dependencies); write the same keys as JSON, e.g. {"web": {"port": 8000}}')
    with open(path) as f:
        return json.load(f)


def settings_from_json(path: str) -> Settings:
    """:class:`Settings` from a JSON file's sections (unknown keys ignored),
    then the environment's overrides."""
    raw = load_config(path) or {}
    s = Settings()
    for section_name in SECTIONS:
        if section_name in raw and isinstance(raw[section_name], dict):
            section = getattr(s, section_name)
            known = {f.name for f in fields(section)}
            updates = {k: v for k, v in raw[section_name].items() if k in known}
            s = replace(s, **{section_name: replace(section, **updates)})
    return s.with_env_overrides()


settings = Settings().with_env_overrides()
