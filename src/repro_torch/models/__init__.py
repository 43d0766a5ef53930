"""repro_torch.models — the language models of the attention families
(dense, vlm, moe, encdec): layers, blocks, the frontend stubs and the
assembled :class:`~repro_torch.models.model.Model` (the port of the
reference's ``repro.models``; the recurrent families wait, ROADMAP
Queue 1)."""

from repro_torch.models.model import PORTED_FAMILIES, Model, build_model, params_from_reference

__all__ = ["PORTED_FAMILIES", "Model", "build_model", "params_from_reference"]
