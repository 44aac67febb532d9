"""Model families of the port (importing registers them)."""

from funasr_torch.models import (  # noqa: F401
    bicif_paraformer, branchformer, campplus, conformer, contextual_paraformer, ct_transformer,
    e_paraformer, emotion2vec, fsmn_vad, paraformer, paraformer_streaming, rwkv,
    scama, seaco_paraformer, sense_voice, transducer, transformer, whisper)
