"""The streaming runtime of the port: online fbank, CTC decoding, read/write
policies, the simulation harness, the KV-cached text decoder, beam and HMT
search, the S2ST inference runtime and the agents (counterpart of
``hifigan_tpu.streaming``)."""

from hifigan_tpu_torch.streaming.decode import ctc_greedy_collapse, ctc_prefix_frames
from hifigan_tpu_torch.streaming.features import FbankConfig, OnlineFbank
from hifigan_tpu_torch.streaming.harness import (
    ReadAction,
    SpeechSegment,
    TextSegment,
    WriteAction,
    run_streaming_session,
)
from hifigan_tpu_torch.streaming.policy import StreamSpeechPolicy, WaitKPolicy

__all__ = ["FbankConfig", "OnlineFbank", "ReadAction", "SpeechSegment", "StreamSpeechPolicy", "TextSegment",
           "WaitKPolicy", "WriteAction", "ctc_greedy_collapse", "ctc_prefix_frames", "run_streaming_session"]
