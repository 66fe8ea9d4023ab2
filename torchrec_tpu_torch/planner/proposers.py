"""Proposal generation.

Counterpart of torchrec_tpu/planner/proposers.py. GreedyProposer: each
table's best-perf option, then proposals that move the table whose choice
is worst to its next option. UniformProposer: one proposal per sharding
type that every table can take, each table on its best option of it.
"""

from __future__ import annotations

from typing import Dict, List

from torchrec_tpu_torch.parallel.types import ShardingType
from torchrec_tpu_torch.planner.types import Proposer, ShardingOption


class GreedyProposer(Proposer):
    def __init__(self, max_proposals: int = 16):
        self._max = max_proposals

    def propose(
        self, options_by_table: Dict[str, List[ShardingOption]]
    ) -> List[List[ShardingOption]]:
        ranked = {name: sorted(opts, key=lambda o: o.total_perf)
                  for name, opts in options_by_table.items()}
        cursor = {name: 0 for name in ranked}
        proposals: List[List[ShardingOption]] = []
        for _ in range(self._max):
            proposals.append([ranked[n][cursor[n]] for n in ranked])
            movable = [n for n in ranked if cursor[n] + 1 < len(ranked[n])]
            if not movable:
                break
            worst = max(movable,
                        key=lambda n: ranked[n][cursor[n]].total_perf)
            cursor[worst] += 1
        return proposals


class UniformProposer(Proposer):
    def propose(
        self, options_by_table: Dict[str, List[ShardingOption]]
    ) -> List[List[ShardingOption]]:
        proposals = []
        for st in ShardingType:
            picks = []
            for opts in options_by_table.values():
                match = [o for o in opts if o.sharding_type is st]
                if not match:
                    picks = []
                    break
                picks.append(min(match, key=lambda o: o.total_perf))
            if picks:
                proposals.append(picks)
        return proposals
