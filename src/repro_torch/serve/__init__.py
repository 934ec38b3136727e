"""Serving engine package (port of the reference's ``repro/serve``).

``Engine``/``ServeConfig`` (the real serving engine) are exposed lazily
(PEP 562) so that importing :mod:`repro_torch.serve.playbook` — pure ladder
rules the mitigation registry needs — never pulls in the model.
"""
from __future__ import annotations

_ENGINE_EXPORTS = ("Engine", "ServeConfig")

__all__ = list(_ENGINE_EXPORTS)


def __getattr__(name: str):
    if name in _ENGINE_EXPORTS:
        from repro_torch.serve import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
