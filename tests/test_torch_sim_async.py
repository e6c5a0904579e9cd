"""The port's ``simulate`` against the reference's: bounded staleness
(``max_staleness`` 2 with a 4x slower worker: unbarriered ZO rounds on stale
views, both engines, both replay modes), two pods with a ring collective
(the hierarchical reduce; HO-SGD in both replay modes, gossip PA-SGD) and
overlap buckets 2 (the exposed-comm pricing; flat per worker, tree
monolithic).

The set-up and the rules (exact traces and bytes, losses to rtol 1e-4,
parameters by the ROADMAP's rules) are ``torch_sim_helpers``'s.
"""
import pytest
import torch

import torch_sim_helpers as H

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def reference_auto_branch(monkeypatch):
    H.reference_auto_branch(monkeypatch)


@pytest.fixture(scope="module")
def problem():
    return H.make_problem()


@pytest.mark.parametrize("case", H.CASES["test_torch_sim_async"], ids=H.case_id)
def test_simulate_matches_reference(problem, monkeypatch, case):
    H.check_against_reference(problem, monkeypatch, case)
