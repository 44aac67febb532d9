"""funasr_torch: the PyTorch/CUDA port of funasr_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; every Pallas kernel of the JAX package on the
ported path is a hand-written CUDA C++ kernel under ``csrc/``, built with
``nvcc`` for ``sm_90a`` at first use (``ops/cuda_build.py``) and bound with
``ctypes``.  The package imports ``torch``, numpy and the standard library
only; the JAX package stays the reference its tests compare against.

Entry points (``auto.auto_model.AutoModel``, the long-audio pipeline;
``auto.engines.ParaformerEngine``, ``BiCifEngine``, ``HybridEngine``,
``VadEngine`` and ``PuncEngine``; ``models.paraformer.model.Paraformer``,
``models.bicif_paraformer.model.BiCifParaformer``,
``models.transformer.model.Conformer`` and ``Transformer``,
``models.branchformer.Branchformer`` and ``EBranchformer``,
``models.fsmn_vad.model.FsmnVADStreaming``,
``models.whisper.model.WhisperWrap`` and ``WhisperLID`` with
``auto.engines.WhisperEngine``,
``models.ct_transformer.model.CTTransformerModel``; streaming:
``models.paraformer_streaming.model.ParaformerStreaming`` with
``frontends.streaming.StreamingFrontend``, and
``runtime.websocket_server.build_streaming_model``)
run on ``cuda`` by default and raise without a GPU unless the caller asks
for ``device="cpu"``.  ``runtime.websocket_server.AsrWebSocketServer``
serves the models it is given (offline, online and 2pass modes), its
offline pass behind ``runtime.batcher.BatchingAutoModel``.
"""

__version__ = "0.1.0"
