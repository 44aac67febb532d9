"""Rules of the port: no JAX at run time, no silent CPU fallback."""

import ast
from pathlib import Path

import pytest
import torch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "funasr_tpu", "sklearn")


def _port_files():
    return sorted((ROOT / "funasr_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "port_ab.py",
        ROOT / "tools" / "fbank_variants.py", ROOT / "tools" / "ffn_variants.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and all(p.exists() for p in files)
    bad = [(str(p.relative_to(ROOT)), name) for p in files
           for name in _imports(p) if name.split(".")[0] in BANNED]
    assert not bad, bad


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(monkeypatch):
    from funasr_torch.auto.engines import FrontendConfig, ParaformerEngine
    from funasr_torch.device import resolve_device
    from funasr_torch.models.paraformer.model import Paraformer
    from funasr_torch.tokenizer.char_tokenizer import CharTokenizer

    _no_gpu(monkeypatch)
    conf = dict(vocab_size=8, input_size=16,
                encoder_conf=dict(output_size=8, attention_heads=2,
                                  linear_units=8, num_blocks=1, kernel_size=3),
                decoder_conf=dict(attention_heads=2, linear_units=8,
                                  num_blocks=1, att_layer_num=1, kernel_size=3))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no GPU"):
            resolve_device(device)
        with pytest.raises(RuntimeError, match="no GPU"):
            Paraformer(**conf, device=device)
    model = Paraformer(**conf, device="cpu")
    tok = CharTokenizer(["<blank>", "<s>", "</s>", "a"])
    with pytest.raises(RuntimeError, match="no GPU"):
        ParaformerEngine(model, FrontendConfig(lfr_m=1, lfr_n=1, n_mels=16),
                         tok)
    engine = ParaformerEngine(model, FrontendConfig(lfr_m=1, lfr_n=1,
                                                    n_mels=16), tok,
                              device="cpu")
    assert engine.device.type == "cpu"

    from funasr_torch.auto.engines import HybridEngine
    from funasr_torch.models.transformer.model import Conformer

    hconf = dict(vocab_size=8, input_size=16,
                 encoder_conf=dict(output_size=8, attention_heads=2,
                                   linear_units=8, num_blocks=1,
                                   cnn_module_kernel=3),
                 decoder_conf=dict(attention_heads=2, linear_units=8,
                                   num_blocks=1))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no GPU"):
            Conformer(**hconf, device=device)
    hybrid = Conformer(**hconf, device="cpu")
    frontend = FrontendConfig(lfr_m=1, lfr_n=1, n_mels=16)
    with pytest.raises(RuntimeError, match="no GPU"):
        HybridEngine(hybrid, frontend, tok)
    assert HybridEngine(hybrid, frontend, tok, device="cpu").device.type == "cpu"

    from funasr_torch.auto.engines import BiCifEngine
    from funasr_torch.models.bicif_paraformer.model import BiCifParaformer

    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no GPU"):
            BiCifParaformer(**conf, device=device, quantize=True, qmm=True,
                            int8_attn=True)
    bicif = BiCifParaformer(**conf, device="cpu")
    fe = FrontendConfig(lfr_m=1, lfr_n=1, n_mels=16)
    with pytest.raises(RuntimeError, match="no GPU"):
        BiCifEngine(bicif, fe, tok)
    assert BiCifEngine(bicif, fe, tok, device="cpu").device.type == "cpu"


def test_pipeline_entry_points_raise_without_cuda(monkeypatch):
    """``AutoModel``, the VAD and the punctuation model run on the card unless
    given ``device="cpu"``."""
    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.models.ct_transformer.model import CTTransformerModel
    from funasr_torch.models.fsmn_vad.model import FsmnVADStreaming

    _no_gpu(monkeypatch)
    vad = dict(input_dim=16, input_affine_dim=8, fsmn_layers=1, linear_dim=8, proj_dim=4,
               lorder=3, rorder=0, lstride=1, rstride=1, output_affine_dim=8, output_dim=4)
    punc = dict(vocab_size=8, embed_unit=8, att_unit=8,
                encoder_conf=dict(output_size=8, attention_heads=2, linear_units=8,
                                  num_blocks=1, kernel_size=3))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no GPU"):
            AutoModel(device=device)
        with pytest.raises(RuntimeError, match="no GPU"):
            FsmnVADStreaming(encoder_conf=vad, device=device)
        with pytest.raises(RuntimeError, match="no GPU"):
            CTTransformerModel(**punc, device=device)
    cfg = dict(model="FsmnVADStreaming", encoder_conf=vad,
               frontend_conf=dict(n_mels=16, lfr_m=1, lfr_n=1))
    am = AutoModel(model=cfg, punc_model=dict(model="CTTransformer", **punc,
                                              tokenizer_conf={"token_list": list("abcdefgh")}),
                   device="cpu")
    assert am.device.type == "cpu" and am.engine.device.type == "cpu"
    assert next(am.punc_engine.model.module.parameters()).device.type == "cpu"


def test_streaming_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """``ParaformerStreaming``, its frontend and the server's streaming model
    builder run on the card unless given ``device="cpu"``."""
    import numpy as np

    from funasr_torch.frontends.streaming import StreamingFrontend
    from funasr_torch.models.paraformer.model import Paraformer
    from funasr_torch.models.paraformer_streaming.model import ParaformerStreaming
    from funasr_torch.runtime.websocket_server import AsrWebSocketServer, build_streaming_model

    _no_gpu(monkeypatch)
    enc = dict(output_size=8, attention_heads=2, linear_units=8, num_blocks=2, kernel_size=3)
    dec = dict(attention_heads=2, linear_units=8, num_blocks=1, att_layer_num=1,
               kernel_size=3)
    dims = dict(input_size=16, d_model=8, n_head=2, enc_kernel=3, dec_kernel=3,
                n_enc_layers=2, n_dec_layers=1, chunk_size=(0, 4, 2))
    model = Paraformer(vocab_size=8, input_size=16, encoder_conf=enc, decoder_conf=dec,
                       device="cpu")
    path = tmp_path / "stream.npz"
    np.savez(path, **{k: v.numpy() for k, v in model.state_dict().items()})
    cfg = dict(init_param=str(path), encoder_conf=enc, decoder_conf=dec, input_size=16,
               chunk_size=[0, 4, 2], frontend_conf=dict(n_mels=16, lfr_m=1, lfr_n=1))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no GPU"):
            StreamingFrontend(device=device)
        with pytest.raises(RuntimeError, match="no GPU"):
            ParaformerStreaming(model.state_dict(), device=device, **dims)
        with pytest.raises(RuntimeError, match="no GPU"):
            build_streaming_model(cfg, device=device)
    with pytest.raises(RuntimeError, match="no GPU"):
        ParaformerStreaming(model, **dims)
    sm = build_streaming_model(cfg, device="cpu")
    assert sm.device.type == "cpu" and sm.frontend.device.type == "cpu"
    assert next(sm.model.parameters()).device.type == "cpu"
    server = AsrWebSocketServer(None, streaming_model=sm, max_batch=1)
    assert server.streaming_model is sm


def test_speaker_and_hotword_entry_points_raise_without_cuda(monkeypatch):
    """CAM++, SeacoParaformer, ``SpkEngine`` and ``HotwordEngine`` run on
    the card unless given ``device="cpu"``."""
    from funasr_torch.auto.engines import FrontendConfig, HotwordEngine, SpkEngine
    from funasr_torch.models.campplus.model import CAMPPlus
    from funasr_torch.models.seaco_paraformer.model import SeacoParaformer
    from funasr_torch.tokenizer.char_tokenizer import CharTokenizer

    _no_gpu(monkeypatch)
    camp = dict(feat_dim=16, embedding_size=8, growth_rate=4, bn_size=2, init_channels=8,
                blocks=((1, 3, 1),))
    seaco = dict(vocab_size=8, input_size=16, inner_dim=8, no_bias_id=7,
                 encoder_conf=dict(output_size=8, attention_heads=2, linear_units=8,
                                   num_blocks=1, kernel_size=3),
                 decoder_conf=dict(attention_heads=2, linear_units=8, num_blocks=1,
                                   att_layer_num=1, kernel_size=3),
                 seaco_decoder_conf=dict(attention_heads=2, linear_units=8, num_blocks=1,
                                         att_layer_num=1, kernel_size=3))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no GPU"):
            CAMPPlus(**camp, device=device)
        with pytest.raises(RuntimeError, match="no GPU"):
            SeacoParaformer(**seaco, device=device)
    spk = SpkEngine(CAMPPlus(**camp, device="cpu"))
    assert spk.device.type == "cpu" and spk.frontend.n_mels == 16
    model = SeacoParaformer(**seaco, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    tok = CharTokenizer(["<blank>", "<s>", "</s>", "a", "b", "c", "d", "<unk>"])
    fe = FrontendConfig(lfr_m=1, lfr_n=1, n_mels=16)
    with pytest.raises(RuntimeError, match="no GPU"):
        HotwordEngine(model, fe, tok)
    engine = HotwordEngine(model, fe, tok, device="cpu")
    assert engine.encode_hotwords("ab c").pad.device.type == "cpu"


def test_unknown_model_arguments_raise():
    from funasr_torch.models.paraformer.model import Paraformer

    with pytest.raises(TypeError):
        Paraformer(vocab_size=8, input_size=16, device="cpu", lsm_weigth=0.1)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from funasr_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(["attention"])


def test_kernel_library_path_tracks_sources():
    from funasr_torch.ops import cuda_build

    path = cuda_build.library_path("fbank")
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("libfbank-") and path.suffix == ".so"
    assert all((cuda_build.CSRC / f"{n}.cu").exists()
               for n in cuda_build.SOURCES)


def test_quantized_model_raises_without_cuda(monkeypatch):
    from funasr_torch.models.paraformer.model import Paraformer

    _no_gpu(monkeypatch)
    conf = dict(vocab_size=8, input_size=16, quantize=True,
                encoder_conf=dict(output_size=8, attention_heads=2,
                                  linear_units=8, num_blocks=2, kernel_size=3),
                decoder_conf=dict(attention_heads=2, linear_units=8,
                                  num_blocks=1, att_layer_num=1, kernel_size=3))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no GPU"):
            Paraformer(**conf, device=device)
    model = Paraformer(**conf, device="cpu", dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.quantize_weights() is model


def _meta_cases():
    """Each new wrapper with tensors on the meta device (neither CPU nor
    CUDA): shapes are valid, so only the device rule can refuse them."""
    from funasr_torch.ops import attention as A
    from funasr_torch.ops import ctc_prefix as CP
    from funasr_torch.ops import decoder_layer as DL
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import fsmn as FS
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import qmm as QM
    from funasr_torch.ops import quant as Q
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops import sanm_layer as SL

    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    i8 = lambda *s: m(*s, dt=torch.int8)
    B, T, D = 2, 8, 256
    sanm = SL.SanmLayerWeights(*[m(1)] * 17)
    dec = DL.DecoderLayerWeights(*[m(1)] * 23)
    ffn = FF.FfnInt8Weights(i8(32, 16), m(32), m(32), i8(16, 32), m(16), m(16))
    lens = m(B, dt=torch.int32)
    return [
        ("int8_gemm", lambda: G.int8_gemm(i8(4, 16), m(4), i8(8, 16), m(8))),
        ("rowquant", lambda: RQ.rowquant(m(4, 16))),
        ("fsmn", lambda: FS.fsmn(m(B, T, D), lens, m(3, D), 1)),
        ("attention_f32ctx", lambda: A.attention_f32ctx(
            m(B, T, D), m(B, T, D), m(B, T, D), m(B, T), 2, 0.088)),
        ("int8_linear", lambda: Q.int8_linear(m(4, 16), i8(8, 16), m(8))),
        ("fused_ffn_int8", lambda: FF.fused_ffn_int8(m(4, 16), ffn)),
        ("fused_sanm_layer", lambda: SL.fused_sanm_layer(m(B, T, D), lens, sanm, 2, 1)),
        ("fused_decoder_layer", lambda: DL.fused_decoder_layer(
            m(B, T, D), m(B, T, D), lens, lens, dec, 2, 1)),
        ("ctc_recurrence", lambda: CP.ctc_recurrence(m(B, 3, 4, T), m(B, T),
                                                     m(B, 3, 4, T))),
        ("quant_matmul", lambda: QM.quant_matmul(m(4, 16), i8(8, 16), m(8))),
        ("attention_i8qk", lambda: A.attention_i8qk(
            m(B, T, D), m(B, T, D), m(B, T, D), m(B, T), 2, 0.088)),
        ("fused_ffn", lambda: FF.fused_ffn(m(4, 32), m(64, 32), m(64), m(16, 64), m(16))),
    ]


@pytest.mark.parametrize("case", range(12))
def test_new_wrappers_refuse_other_devices(case):
    name, call = _meta_cases()[case]
    with pytest.raises(ValueError, match="unsupported device"):
        call()


def test_int8_sources_are_built_and_hashed(monkeypatch, tmp_path):
    from funasr_torch.ops import cuda_build

    for name in ("int8_gemm", "rowquant", "fsmn", "qmm", "ffn"):
        assert name in cuda_build.SOURCES
        assert (cuda_build.CSRC / f"{name}.cu").exists()
    before = cuda_build.library_path("int8_gemm").name
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in cuda_build.CSRC.glob("*.cu"):
        text = path.read_text()
        if path.name == "rowquant.cu":
            text += "\n// edited\n"
        (csrc / path.name).write_text(text)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    after = cuda_build.library_path("int8_gemm").name
    assert after.startswith("libint8_gemm-") and after != before


def test_sensevoice_entry_points_raise_without_cuda(monkeypatch):
    """SenseVoiceSmall, ``SenseVoiceEngine`` and ``AutoModel`` with a
    SenseVoice config run on the card unless given ``device="cpu"``; the
    new text, tokenizer and CTC modules import no JAX."""
    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.auto.engines import FrontendConfig, SenseVoiceEngine
    from funasr_torch.models.sense_voice.model import SenseVoiceSmall
    from funasr_torch.tokenizer.char_tokenizer import CharTokenizer
    from funasr_torch.tokenizer.sensevoice_tokenizer import generated_token_list

    _no_gpu(monkeypatch)
    conf = dict(vocab_size=40, input_size=16,
                encoder_conf=dict(output_size=8, attention_heads=2, linear_units=8,
                                  num_blocks=2, tp_blocks=1, kernel_size=3))
    cfg = dict(model="SenseVoiceSmall", tokenizer_conf={"token_list": generated_token_list(40)},
               frontend_conf=dict(n_mels=16, lfr_m=1, lfr_n=1), **conf)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no GPU"):
            SenseVoiceSmall(**conf, device=device)
        with pytest.raises(RuntimeError, match="no GPU"):
            SenseVoiceSmall(**conf, device=device, quantize=True, dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="no GPU"):
            AutoModel(model=cfg, device=device)
    model = SenseVoiceSmall(**conf, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    tok = CharTokenizer(generated_token_list(40))
    fe = FrontendConfig(lfr_m=1, lfr_n=1, n_mels=16)
    with pytest.raises(RuntimeError, match="no GPU"):
        SenseVoiceEngine(model, fe, tok)
    assert SenseVoiceEngine(model, fe, tok, device="cpu").device.type == "cpu"
    am = AutoModel(model=cfg, device="cpu", quantize=True)
    assert am.engine.handles_itn and am.engine.module.encoder.tp_encoders[0].int8 is not None
    new = [ROOT / "funasr_torch" / p for p in (
        "text/itn.py", "text/itn_classes.py", "text/itn_semiotic.py", "text/__init__.py",
        "tokenizer/sentencepiece_tokenizer.py", "tokenizer/sensevoice_tokenizer.py",
        "ops/ctc_decode.py", "ops/ctc_align.py", "models/sense_voice/model.py")]
    assert all(p in _port_files() for p in new)
    assert not [n for p in new for n in _imports(p) if n.split(".")[0] in BANNED]


def test_generated_token_list_and_optional_tokenizers():
    """The stand-in vocabulary holds the rich tags at the released ids; the
    SentencePiece and tiktoken tokenizers are registered under their JAX
    names and import their packages only when built."""
    from funasr_torch.models.sense_voice.model import LID_INT_DICT, TEXTNORM_INT_DICT
    from funasr_torch.registry import tables
    from funasr_torch.tokenizer.sensevoice_tokenizer import NUMBER_WORDS, generated_token_list

    full = generated_token_list()
    assert len(full) == len(set(full)) == 25055 and full[0] == "<unk>"
    assert [full[i] for i in sorted(LID_INT_DICT)] == [
        "<|zh|>", "<|en|>", "<|yue|>", "<|ja|>", "<|ko|>", "<|nospeech|>"]
    assert [full[i] for i in sorted(TEXTNORM_INT_DICT)] == ["<|withitn|>", "<|woitn|>"]
    assert set(NUMBER_WORDS) <= set(full) and "<|HAPPY|>" in full and "<|Speech|>" in full
    small = generated_token_list(40)
    assert len(set(small)) == 40 and "<|zh|>" in small and "三" in small
    for name in ("SentencepiecesTokenizer", "SenseVoiceTokenizer"):
        assert tables.get("tokenizer_classes", name)
    import importlib.util

    if importlib.util.find_spec("sentencepiece") is None:
        with pytest.raises(ImportError, match="sentencepiece"):
            tables.get("tokenizer_classes", "SentencepiecesTokenizer")(bpemodel="x.model")
    if importlib.util.find_spec("tiktoken") is None:
        with pytest.raises(ImportError):
            tables.get("tokenizer_classes", "SenseVoiceTokenizer")(vocab_path="x.tiktoken")


def _autograd_cases():
    """Each ctypes kernel wrapper with CPU tensors of valid shapes, one float
    input requiring grad (``g``)."""
    from funasr_torch.ops import attention as A
    from funasr_torch.ops import ctc_prefix as CP
    from funasr_torch.ops import decoder_layer as DL
    from funasr_torch.ops import fbank_kernel as FK
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import fsmn as FS
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import qmm as QM
    from funasr_torch.ops import quant as Q
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops import sanm_layer as SL
    from funasr_torch.ops import wkv as W

    def g(*s):
        return torch.randn(*s, requires_grad=True)

    i8 = lambda *s: torch.zeros(s, dtype=torch.int8)
    f = lambda *s: torch.ones(s)
    B, T, D = 2, 8, 64
    lens = torch.tensor([8, 5], dtype=torch.int32)
    ffn8 = FF.FfnInt8Weights(i8(32, 16), f(32), f(32), i8(16, 32), f(16), f(16))
    sanm = SL.SanmLayerWeights(*[f(1)] * 17)
    dec = DL.DecoderLayerWeights(*[f(1)] * 23)
    return [
        ("fused_attention", lambda: A.fused_attention(g(B, T, D), f(B, T, D), f(B, T, D),
                                                      torch.zeros(B, T), 2)),
        ("attention_f32ctx", lambda: A.attention_f32ctx(f(B, T, D), g(B, T, D), f(B, T, D),
                                                        torch.zeros(B, T), 1, 0.125)),
        ("attention_i8qk", lambda: A.attention_i8qk(f(B, T, D), f(B, T, D), g(B, T, D),
                                                    torch.zeros(B, T), 1, 0.125)),
        ("fused_fbank", lambda: FK.fused_fbank(g(B, 1600), torch.tensor([1600, 900]))),
        ("ctc_prefix_step", lambda: CP.ctc_prefix_step(
            g(B, 5, T), f(B, 3, T, 2), torch.zeros(B, 3, dtype=torch.int64),
            torch.zeros(B, 3, 4, dtype=torch.int64), False)),
        ("ctc_recurrence", lambda: CP.ctc_recurrence(g(B, 3, 4, T), f(B, T), f(B, 3, 4, T))),
        ("fused_ffn", lambda: FF.fused_ffn(g(4, 32), f(64, 32), f(64), f(16, 64), f(16))),
        ("fused_ffn_int8", lambda: FF.fused_ffn_int8(g(4, 16), ffn8)),
        ("fsmn", lambda: FS.fsmn(g(B, T, D), lens, f(3, D), 1)),
        ("fsmn_ln", lambda: FS.fsmn_ln(f(B, T, D), (g(D), f(D)), lens, f(3, D), 1)),
        ("int8_gemm", lambda: G.int8_gemm(i8(4, 16), g(4), i8(8, 16), f(8))),
        ("int8_gemm_rq", lambda: G.int8_gemm_rq(g(4, 16), i8(8, 16), f(8), None)),
        ("quant_matmul", lambda: QM.quant_matmul(g(4, 16), i8(8, 16), f(8))),
        ("int8_linear", lambda: Q.int8_linear(g(4, 16), i8(8, 16), f(8))),
        ("rowquant", lambda: RQ.rowquant(g(4, 16))),
        ("fused_sanm_layer", lambda: SL.fused_sanm_layer(g(B, T, D), lens, sanm, 2, 1)),
        ("fused_decoder_layer", lambda: DL.fused_decoder_layer(
            f(B, T, D), g(B, T, D), lens, lens, dec, 2, 1)),
        ("wkv", lambda: W.wkv(f(B, T, 4), f(B, T, 4), g(4), f(4))),
    ]


@pytest.mark.parametrize("case", range(18))
def test_wrappers_refuse_autograd(case):
    """Every ctypes kernel wrapper raises, naming itself, when grad mode is on
    and an input requires grad: its result would carry no ``grad_fn`` and cut
    the graph silently.  The check comes before the device choice, so it
    holds on the CPU (the twin) as on the card."""
    name, call = _autograd_cases()[case]
    with pytest.raises(RuntimeError, match=f"^{name}: an input requires grad"):
        call()
    if name in ("fused_attention", "rowquant", "wkv", "fsmn"):
        with torch.no_grad():
            call()  # the twin runs once grad is off
