"""The tiny cells on the card, with the port's CUDA kernels (``-m gpu``)."""
import pytest

import tinybench


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return tinybench.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.gpu
@pytest.mark.parametrize("workload,seconds", [("hymba-tiny.train", 0.01), ("mamba-tiny.serve", 1.0)])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cells_on_the_card(card_root, workload, seconds, trace):
    result, checks = tinybench.run(card_root, workload, seconds=seconds, trace=trace,
                                   device="cuda")
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0 and "breakdown" in result
