"""Consolidated serving configuration (port of the reference
``serve/config.py``, copied: the same fields, rule tables and messages).

A frozen :class:`ServeConfig` carries every serving knob and is validated
at construction by one declarative rule table (:data:`ENUM_RULES` +
:data:`CROSS_RULES`) whose messages name the conflicting fields.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

# --------------------------------------------------------------------------
# the validation table: enum membership first, then cross-field conflicts.
# Every message names the offending field(s) — a reader should never have
# to grep a second module to learn which knob to change.
# --------------------------------------------------------------------------

ENUM_RULES = (
    ("admission", ("host", "device")),
    ("admission_policy", ("hybrid", "multiqueue")),
    ("admission_storage", ("flat", "klsm")),
    ("preemption", ("off", "margin")),
    ("packer", ("thread", "sync")),
    ("step", (None, "host", "device", "fused", "continuous")),
)

CROSS_RULES = (
    (
        lambda c: c.preempt_margin < 0,
        "preempt_margin must be >= 0",
    ),
    (
        lambda c: c.step_chunk < 1,
        "step_chunk must be >= 1",
    ),
    (
        lambda c: c.admission_capacity < 1,
        "admission_capacity must be >= 1",
    ),
    (
        lambda c: (c.admission_policy == "multiqueue"
                   and c.preemption != "off"),
        "admission_policy='multiqueue' conflicts with preemption="
        "'margin': the sampled pop has no peek-then-pop front contract "
        "for the preemption rounds to rely on",
    ),
    (
        lambda c: (c.admission_storage == "klsm"
                   and c.admission_policy == "multiqueue"),
        "admission_storage='klsm' conflicts with admission_policy="
        "'multiqueue': the level store indexes the HYBRID published set "
        "(a sampled pop has no global front for it to index)",
    ),
)


@dataclass(frozen=True)
class ServeConfig:
    """Every serving knob of :class:`~repro_torch.serve.engine.ServeEngine`
    in one frozen, validated value. Model geometry (``cfg``,
    ``params``, ``slots``, ``max_len``, ``frontends``, ``k``) stays on the
    engine call — it describes the model and its capacity, not the
    scheduling behavior this config owns.

    ``step`` subsumes ``admission``: ``"host"``/``"device"`` are the eager
    per-step planes (and force the matching admission), ``"fused"`` the
    single-dispatch loop, ``"continuous"`` the fused loop with
    double-buffered arrival plans, and ``None`` defers to ``admission``
    (see :meth:`resolved`). The port runs the host plane only; the engine
    raises ``NotImplementedError`` for the others.
    """

    admission: str = "host"
    admission_policy: str = "hybrid"
    admission_storage: str = "flat"
    admission_capacity: int = 256
    step: Optional[str] = None
    step_chunk: int = 1
    preemption: str = "off"
    preempt_margin: float = 0.0
    staging_rows: Optional[int] = None
    slo: Optional[Any] = None            # SLO policy (not ported yet)
    packer: str = "thread"
    mesh: Optional[Any] = None           # device mesh (not ported yet)

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Run the declarative rule table; raise ``ValueError`` naming the
        offending field(s) on the first violation. Called automatically at
        construction, so an invalid combination is unrepresentable."""
        for field, legal in ENUM_RULES:
            value = getattr(self, field)
            if value not in legal:
                raise ValueError(
                    f"{field}={value!r} is not one of {legal!r}")
        for bad, message in CROSS_RULES:
            if bad(self):
                raise ValueError(message)

    def resolved(self) -> "ServeConfig":
        """The config with ``step``/``admission`` normalized the way the
        engine runs them: ``step=None`` falls back to the eager plane named
        by ``admission``; ``step="host"|"device"`` forces ``admission`` to
        match. Idempotent; the result's ``step`` is never ``None``."""
        step = self.admission if self.step is None else self.step
        admission = step if step in ("host", "device") else self.admission
        if step == self.step and admission == self.admission:
            return self
        return dataclasses.replace(self, step=step, admission=admission)


# Field names the legacy ``ServeEngine(admission=..., step=..., ...)``
# kwargs map onto 1:1: the shim builds ``ServeConfig(**legacy)`` from
# exactly these and warns.
LEGACY_KWARGS = tuple(f.name for f in dataclasses.fields(ServeConfig))
