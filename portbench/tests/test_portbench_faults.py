"""The check that decides `correct`, with the timed path broken underneath:
a whole run of each cell (the device's look aside) comes out not correct
once for each fault the cell can have, and correct without one."""

import pytest

pytest.importorskip("torch")

from portbench.tests import smoke

CASES = [
    ("hubert-xlarge-dr.train", None),
    ("hubert-xlarge-dr.train", "unchanged"),      # a step returns the state it was given
    ("hubert-xlarge-dr.train", "half_batch"),     # half the rows left out, the mean over the rest
    ("internvl2-1b-dr.prefill", None),
    ("internvl2-1b-dr.prefill", "unchanged"),     # the DR update returns the staged state as given
    ("internvl2-1b-dr.prefill", "answer_altered"),  # a served answer altered where it is produced
    ("hubert-xlarge-dr.encode", None),
    ("hubert-xlarge-dr.encode", "answer_altered"),
    ("internvl2-1b-dr.answer", None),
    ("internvl2-1b-dr.answer", "unchanged"),
    ("internvl2-1b-dr.answer", "answer_altered"),     # the first token's logits altered
    ("internvl2-1b-dr.answer", "decode_unchanged"),   # a decode step hands back the cache it got
    ("internvl2-1b-dr.answer", "token_altered"),      # a decoded token altered where it is made
]


@pytest.mark.parametrize("cell,fault", CASES, ids=lambda v: str(v))
def test_correct_only_without_a_fault(cell, fault):
    res, checks = smoke.run(cell, fault=fault)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(checks) == set(res["checks"])
    assert res["correct"] is (fault is None), checks
