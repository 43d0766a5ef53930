"""repro_torch.models — the language models of every family (dense,
vlm, moe, encdec; ssm, rwkv, hybrid): layers, the chunked linear
attention, blocks, the frontend stubs and the assembled
:class:`~repro_torch.models.model.Model` (the port of the reference's
``repro.models``)."""

from repro_torch.models.model import PORTED_FAMILIES, Model, build_model, params_from_reference

__all__ = ["PORTED_FAMILIES", "Model", "build_model", "params_from_reference"]
