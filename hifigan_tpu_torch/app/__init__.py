"""The real-time translation application: the cascade engine (ASR → MT →
TTS → the port's vocoder), audio processing and VAD, the offline model
manager, the web server (FastAPI when installed, else the standard
library's) and the desktop UI.  Counterpart of ``hifigan_tpu/app``."""

from hifigan_tpu_torch.app.audio import AudioProcessor, RealTimeAudioStream
from hifigan_tpu_torch.app.config import Settings, load_config, settings
from hifigan_tpu_torch.app.engine import (
    RealTimeTranslationEngine,
    TranslationEngineFactory,
    TranslationMode,
    TranslationResult,
)
from hifigan_tpu_torch.app.offline import OfflineManager, offline_manager

__all__ = [
    "Settings",
    "load_config",
    "settings",
    "AudioProcessor",
    "RealTimeAudioStream",
    "RealTimeTranslationEngine",
    "TranslationEngineFactory",
    "TranslationMode",
    "TranslationResult",
    "OfflineManager",
    "offline_manager",
]
