"""Operator-defined eligibility policy (paper §7).

Three execution levels (Level 0 prep-only / Level 1 read-only-replayable /
Level 2 staged-write) plus per-tool overrides and *transformed speculation*
(PASTE's example: web search speculates freely while pip_install degrades to
a dry-run/download-only variant).  By construction no speculative side
effect becomes externally visible unless the authoritative path converges —
commits require authoritative confirmation (sandbox.commit at promotion).

Paper anchor: §7 (execution levels, operator policy), Eq. 1's σ.
Upstream: events.py (ToolSpec default levels/transforms).  Downstream:
runtime.py (speculative_form gating at beam build, ``servable`` gating of
store serves), hypothesis.py (BARRIER insertion before Level-2 nodes).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.events import DEFAULT_TOOLS, SafetyLevel, ToolSpec


@dataclass
class EligibilityPolicy:
    """max_level: strictest class the runtime may *speculatively start*.
    Level-2 nodes may only run inside a sandbox behind a commit barrier."""
    max_level: SafetyLevel = SafetyLevel.STAGED_WRITE
    overrides: Dict[str, SafetyLevel] = field(default_factory=dict)
    transforms: Dict[str, str] = field(default_factory=dict)
    tools: Dict[str, ToolSpec] = field(default_factory=lambda: dict(DEFAULT_TOOLS))

    def __post_init__(self):
        for name, spec in self.tools.items():
            if not spec.transformed or name in self.transforms:
                continue
            # An explicit operator override to NON_SPECULATIVE is a ban:
            # do NOT auto-install the spec's transform for it, or the tool
            # keeps speculating through the degraded variant anyway.
            if self.overrides.get(name) == SafetyLevel.NON_SPECULATIVE:
                continue
            self.transforms[name] = spec.transformed

    def level(self, tool: str) -> SafetyLevel:
        if tool in self.overrides:
            return self.overrides[tool]
        spec = self.tools.get(tool)
        return spec.level if spec else SafetyLevel.NON_SPECULATIVE

    def eligible(self, tool: str) -> bool:
        """True iff the tool can speculate in *some* form.  Definitionally
        ``speculative_form(tool) is not None`` — keeping the two in sync by
        construction (they drifted before: a transform-degradable staged
        write under a READ_ONLY policy was form-runnable but "ineligible")."""
        return self.speculative_form(tool) is not None

    def speculative_form(self, tool: str) -> Optional[Tuple[str, bool]]:
        """(tool_to_run, transformed?) for speculative execution, or None if
        ineligible.  Tools above max_level degrade to their transformed
        variant when one exists *and the transform target itself clears the
        policy*.  An explicit NON_SPECULATIVE override is an operator ban
        and wins over any transform."""
        if self.overrides.get(tool) == SafetyLevel.NON_SPECULATIVE:
            return None
        lvl = self.level(tool)
        if lvl != SafetyLevel.NON_SPECULATIVE and lvl <= self.max_level:
            return (tool, False)          # Level-2 ⇒ sandbox + barrier
        t2 = self.transforms.get(tool)
        if t2 is not None:
            lvl2 = self.level(t2)
            if lvl2 != SafetyLevel.NON_SPECULATIVE and lvl2 <= self.max_level:
                return (t2, True)
        return None

    def servable(self, tool: str) -> Optional[str]:
        """How a stored result may satisfy an AUTHORITATIVE action from the
        cross-episode result store (memo.py):

          "direct" — PREP_ONLY / READ_ONLY: the result is replayable by
                     definition, serve it as-is (only when the policy admits
                     speculation at that level at all — a stored result only
                     exists because some runtime speculated the action);
          "replay" — STAGED_WRITE: serve by replaying the stored write
                     overlay through the commit barrier onto the live state
                     (version bump included), allowed only when the operator
                     admits staged speculation at all;
          None     — NON_SPECULATIVE (and anything above max_level): always
                     re-execute authoritatively.
        """
        if self.overrides.get(tool) == SafetyLevel.NON_SPECULATIVE:
            return None
        lvl = self.level(tool)
        if lvl <= SafetyLevel.READ_ONLY and lvl <= self.max_level:
            return "direct"
        if lvl == SafetyLevel.STAGED_WRITE and self.max_level >= SafetyLevel.STAGED_WRITE:
            return "replay"
        return None

    def requires_sandbox_write(self, tool: str) -> bool:
        return self.level(tool) >= SafetyLevel.STAGED_WRITE


READ_ONLY_POLICY = EligibilityPolicy(max_level=SafetyLevel.READ_ONLY)
PREP_ONLY_POLICY = EligibilityPolicy(max_level=SafetyLevel.PREP_ONLY)
FULL_POLICY = EligibilityPolicy(max_level=SafetyLevel.STAGED_WRITE)
