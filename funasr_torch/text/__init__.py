"""Rule-based inverse text normalization (copy of funasr_tpu/text/; the
forward TN modules are not ported)."""

from funasr_torch.text.itn import inverse_normalize  # noqa: F401
