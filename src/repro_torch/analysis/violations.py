"""The shared finding type of the static-check suite.

Every pass in ``repro_torch.analysis.check`` returns a flat list of
:class:`Violation` records; the CLI renders them and exits non-zero when
any survive. Kept in its own stdlib-only module so pass modules and the
CLI can share it without import cycles. A copy of the JAX package's
``analysis/violations.py``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Violation:
    """One static-contract failure.

    passname: which checker found it (``registry`` / ``smem``).
    subject:  the thing checked — a step-case name, kernel family,
              registry entry, or file.
    message:  human-readable description of the broken invariant.
    """
    passname: str
    subject: str
    message: str

    def __str__(self) -> str:
        return f"[{self.passname}] {self.subject}: {self.message}"


def render(violations: list[Violation], *, checked: int,
           passname: str) -> str:
    """One pass's summary line for the CLI report."""
    if not violations:
        return f"PASS {passname}: {checked} subject(s) clean"
    lines = [f"FAIL {passname}: {len(violations)} violation(s) "
             f"across {checked} subject(s)"]
    lines += [f"  - {v}" for v in violations]
    return "\n".join(lines)
