"""Plan statistics: each rank's memory and estimated time, and each
table's placement, as text (logged at INFO). Counterpart of
torchrec_tpu/planner/stats.py."""

from __future__ import annotations

import logging
from typing import List

from torchrec_tpu_torch.planner.types import ShardingOption, Topology

logger = logging.getLogger(__name__)


class EmbeddingStats:
    def log(
        self,
        plan: List[ShardingOption],
        topology: Topology,
        best_perf: float,
    ) -> str:
        per_rank_hbm = [0.0] * topology.world_size
        per_rank_perf = [0.0] * topology.world_size
        rows = []
        for opt in plan:
            ranks = sorted({s.rank for s in opt.shards if s.rank is not None})
            for s in opt.shards:
                if s.rank is not None:
                    per_rank_hbm[s.rank] += s.storage.hbm
                    per_rank_perf[s.rank] += s.perf
            rows.append((
                opt.name, opt.sharding_type.value, opt.compute_kernel.value,
                f"{opt.total_storage.hbm / 1024**2:.1f}MiB",
                ",".join(map(str, ranks[:8])) + ("..." if len(ranks) > 8
                                                  else "")))
        lines = [
            f"--- Sharding plan ({topology}) | critical path "
            f"{best_perf*1e3:.2f} ms ---",
            f"{'table':<20}{'sharding':<16}{'kernel':<8}{'hbm':<12}ranks",
        ]
        for r in rows:
            lines.append(f"{r[0]:<20}{r[1]:<16}{r[2]:<8}{r[3]:<12}{r[4]}")
        lines.append("per-rank HBM (MiB): " + " ".join(
            f"{h/1024**2:.0f}" for h in per_rank_hbm))
        lines.append("per-rank perf (ms): " + " ".join(
            f"{p*1e3:.2f}" for p in per_rank_perf))
        text = "\n".join(lines)
        logger.info(text)
        return text
