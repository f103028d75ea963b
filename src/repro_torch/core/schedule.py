"""Static-schedule IR (a copy of the reference's ``core/schedule.py``).

The management core executes a compile-time-determined sequence of DMA
transfers and hands compute kernels to worker cores (paper §3/§4.2).
We model a schedule as a dependency DAG of *phases*; each phase runs on
exactly one serial resource (the DMA engine or one worker core).  The
absence of shared resources between workers — each phase touches only
its own core's scratchpad — is checked structurally by
``validate_interference_freedom``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DMA = "dma"


def core_resource(core_id: int) -> str:
    return f"core{core_id}"


@dataclass(frozen=True)
class Phase:
    """One schedulable unit."""

    pid: int
    kind: str                 # dma_load | dma_store | compute
    resource: str             # DMA or core<i>
    deps: Tuple[int, ...]     # phase ids that must finish first
    # workload descriptors consumed by the timing model:
    bytes_moved: int = 0      # DMA phases: DRAM<->SPM traffic
    macs: int = 0             # compute phases: multiply-accumulates
    vec_chunks: int = 0       # number of vector-instruction chunks
    elems: int = 0            # output elements produced (epilogue cost)
    spm_core: Optional[int] = None   # which core's scratchpad is touched
    tag: str = ""


@dataclass
class Schedule:
    phases: List[Phase] = field(default_factory=list)
    meta: Dict = field(default_factory=dict)

    def add(self, **kw) -> int:
        pid = len(self.phases)
        kw.setdefault("deps", ())
        self.phases.append(Phase(pid=pid, **kw))
        return pid

    def __len__(self):
        return len(self.phases)

    # -- structural invariants (tested with hypothesis) ------------------

    def validate_dag(self) -> None:
        seen = set()
        for ph in self.phases:
            assert ph.pid not in seen
            for d in ph.deps:
                assert d < ph.pid, (
                    f"phase {ph.pid} depends on later phase {d}")
            seen.add(ph.pid)

    def validate_interference_freedom(self) -> None:
        """No worker core's phase may touch another core's scratchpad,
        and only DMA phases may move data between memories — the
        paper's freedom-from-interference property, checked on the IR."""
        for ph in self.phases:
            if ph.kind == "compute":
                cid = int(ph.resource.replace("core", ""))
                assert ph.spm_core in (None, cid), (
                    f"compute phase {ph.pid} on {ph.resource} touches "
                    f"SPM of core {ph.spm_core}")
                assert ph.bytes_moved == 0
            else:
                assert ph.resource == DMA, ph

    def resources(self) -> Sequence[str]:
        return sorted({p.resource for p in self.phases})
