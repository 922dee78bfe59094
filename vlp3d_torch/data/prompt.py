"""Prompt-based synthetic sentence generation (lib/prompt/prompt.py:20-48).

The port's own copy of ``vlp3d/data/prompt.py``.

Generates spatial-relation sentences between two objects for the
`lang_num_aug` augmentation; rng is injected for determinism (the
reference uses module-level random/np.random)."""

from __future__ import annotations

import numpy as np

PROMPT_TEMPLATES = (
    "the {target} is {relation} the {anchor}",
    "the {target} is {relation} a {anchor}",
    "this is a {target}. placed {relation} the {anchor}",
    "there is a {target}. it is {relation} the {anchor}",
    "this is a {target} and it is {relation} the {anchor}",
)

NEXT_TO_WORDS = ("next to", "surrounding", "near", "beside")


class Prompt:
    next_to_dis = 2.5

    def get_relation(self, target_center, anchor_center, rng: np.random.Generator):
        diff = np.asarray(target_center) - np.asarray(anchor_center)
        if diff[0] * diff[0] + diff[1] * diff[1] <= self.next_to_dis:
            return NEXT_TO_WORDS[rng.integers(len(NEXT_TO_WORDS))]
        relation = []
        if target_center[0] + 1 <= anchor_center[0]:
            relation.append("to the left of")
        elif target_center[0] - 1 >= anchor_center[0]:
            relation.append("to the right of")
        if target_center[1] + 1 <= anchor_center[1]:
            relation.append("in front of")
        elif target_center[1] - 1 >= anchor_center[1]:
            relation.append("behind")
        if not relation:  # degenerate diagonal case: fall back to proximity
            return NEXT_TO_WORDS[rng.integers(len(NEXT_TO_WORDS))]
        return relation[rng.integers(len(relation))]

    def get_prompt(self, target, target_center, anchor, anchor_center,
                   rng: np.random.Generator):
        relation = self.get_relation(target_center, anchor_center, rng)
        tpl = PROMPT_TEMPLATES[rng.integers(len(PROMPT_TEMPLATES))]
        return tpl.format(target=target, relation=relation, anchor=anchor)
