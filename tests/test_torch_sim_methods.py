"""The port's ``simulate`` against the reference's: every method of
``make_sim_methods`` not covered elsewhere on the synchronous cluster
(adaptive-tau HO-SGD, sync-SGD, ZO-SGD on tree and flat, PA-SGD, gossip PA-
SGD, RI-SGD and QSGD handed the reference's draws, QSGD monolithic) and HO-
SGD's FO codec (QSGD per worker, sync-SGD's legacy).

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


@pytest.mark.parametrize("case", H.CASES["test_torch_sim_methods"], ids=H.case_id)
def test_simulate_matches_reference(problem, monkeypatch, case):
    H.check_against_reference(problem, monkeypatch, case)
