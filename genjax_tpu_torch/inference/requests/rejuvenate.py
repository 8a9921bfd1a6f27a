"""``Rejuvenate``: Metropolis-Hastings with a custom proposal as an edit
request (no accept step; the weight is the log-acceptance ratio).

Counterpart of ``genjax_tpu/inference/requests/rejuvenate.py``, with its
correction of the backward move: the reverse kernel proposes the old values
from the NEW trace's choices, so the weight is the exact MH log-ratio. Under
a key the request splits it as the reference does, ``key, sub_key =
split(key)``: the proposal draws under ``sub_key`` and the ``Update`` edits
under ``key``; a generator drives both in sequence.
"""

from __future__ import annotations

from typing import Callable

import torch

from ...core import keys
from ...core.pytree import Pytree
from ...generative.concepts import Argdiffs, EditRequest, Retdiff, Update, Weight
from ...generative.gfi import GenerativeFunction
from ...generative.trace import Trace


@Pytree.dataclass
class Rejuvenate(EditRequest):
    """Propose a change of the trace from ``proposal`` (a generative
    function over the same addresses); the SMCP3 weight is the MH
    log-acceptance ratio. ``argument_mapping`` maps a trace's choices to the
    proposal's arguments (a random walk centred at the current value, say).
    """

    proposal: GenerativeFunction
    argument_mapping: Callable = Pytree.static()

    def edit(
        self, gen: torch.Generator, tr: Trace, argdiffs: Argdiffs
    ) -> tuple[Trace, Weight, Retdiff, EditRequest]:
        sub_gen = gen
        if keys.is_key(gen):
            gen, sub_gen = keys.split(gen).unbind(-2)
        proposed, fwd_score, _ = self.proposal.propose(sub_gen, self.argument_mapping(tr.get_choices()))
        new_tr, w, retdiff, bwd_request = Update(proposed).edit(gen, tr, argdiffs)
        assert isinstance(bwd_request, Update)
        bwd_score, _ = self.proposal.assess(
            bwd_request.constraint, self.argument_mapping(new_tr.get_choices())
        )
        return new_tr, w + bwd_score - fwd_score, retdiff, Rejuvenate(self.proposal, self.argument_mapping)
