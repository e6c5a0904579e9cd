"""Whole runs of each kind of cell at a tiny size on the CPU, with the port's
plain kernel versions: a sound run is correct, and the control and every
fault a cell of its kind can have are not."""
import json

import pytest

import tinybench

TRAIN, SERVE = "hymba-tiny.train", "mamba-tiny.serve"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinybench.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload,seconds", [(TRAIN, 0.01), (SERVE, 1.0)])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(root, workload, seconds, trace):
    result, checks = tinybench.run(root, workload, seconds=seconds, trace=trace)
    assert result["correct"], checks
    assert list(result)[-1] == "checks" and set(result["checks"]) == {n for n, _, _ in checks}
    assert result["attempted"] > 0 and result["failed"] == 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wanted = [m for m in bench["per_layer" if trace else "end_to_end"]
              if workload in m.get("workloads", [workload])]
    host = {"host_clock", "program_counter"}
    for m in wanted:                 # the device's readings stay out of a CPU run
        if m["source"] in host and m["name"] != "peak_mem_gb":
            assert m["name"] in result["metrics"], m["name"]
    assert all(v["value"] > 0 or k == "scan_route_share.serve"
               for k, v in result["metrics"].items())


def test_an_added_metric_is_read_from_its_own_file(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_done.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "trainer",
                               "moves": "train_tokens_per_s", "workloads": [TRAIN]})
    (root / "perfbench/metrics/steps_done.train.py").write_text(
        "def read(run):\n    return float(len(run.get('steps', []))) or None\n")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = tinybench.run(root, TRAIN, seconds=0.01, trace=True)
    assert result["metrics"]["steps_done.train"]["value"] == 4.0    # one period, tau = 4


def _broken(monkeypatch, fault):
    """Break the program under the harness: ``unchanged`` steps return their
    state; ``half`` steps take half of every batch and the mean over it."""
    from repro_torch.core import distributed

    make = distributed.make_distributed_ho_sgd

    def faulty(*a, **kw):
        steps = make(*a, **kw)

        def wrap(step):
            def run(t, params, state, batch):
                if fault == "unchanged":
                    _, _, loss = step(t, params, state, batch)
                    return params, state, loss
                half = {k: v[:len(v) // 2] for k, v in batch.items()}
                return step(t, params, state, half)
            return run
        return tuple(wrap(s) for s in steps)

    monkeypatch.setattr(distributed, "make_distributed_ho_sgd", faulty)


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_broken_training_step_is_not_correct(root, monkeypatch, fault):
    _broken(monkeypatch, fault)
    result, checks = tinybench.run(root, TRAIN, seconds=0.01)
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", ["unscaled", "unperturbed"])
def test_a_broken_zeroth_order_coefficient_is_not_correct(root, monkeypatch, fault):
    """The coefficient ``(d / mu) (f1 - f0)`` without its ``d``, or with both
    losses taken at the unperturbed point."""
    import torch
    from repro_torch.core import engine

    def zo_coeff(self, loss_fn, params, batch, t, worker, mu):
        f0 = loss_fn(params, batch)
        at = params if fault == "unperturbed" else \
            self.perturb(params, t, worker, mu * self.inv_norm(t, worker))
        scale = (1.0 if fault == "unscaled" else self.dim) / mu
        return (scale * (loss_fn(at, batch) - f0)).to(torch.float32), f0

    monkeypatch.setattr(engine.DirectionEngine, "zo_coeff", zo_coeff)
    result, checks = tinybench.run(root, TRAIN, seconds=0.01)
    assert not result["correct"], checks


def test_an_altered_token_is_not_correct(root, monkeypatch):
    from repro_torch.serving import scheduler

    append = scheduler.Scheduler._append

    def altered(self, req, tok, report, phase):
        if len(req.out) == 1 and req.rid % 2 == 0:
            tok = (tok + 1) % self.cfg.vocab_size
        return append(self, req, tok, report, phase)

    monkeypatch.setattr(scheduler.Scheduler, "_append", altered)
    result, checks = tinybench.run(root, SERVE, seconds=1.0)
    assert not result["correct"], checks


def test_the_control_is_not_correct(root):
    """The reference in fp8 put in the program's place fails a number the
    limits hold, for each kind of cell."""
    import torch
    from harness import manifest, serve, train

    cell = manifest.cell(root, TRAIN)
    model, mix = cell.config["model"], cell.traffic
    seed, dev = 2**31 + 29, torch.device("cpu")
    ref = train.reference(model, mix, seed, dev)
    ctrl = train.numbers(train.reference(model, mix, seed, dev, control=True), ref, mix)
    assert any(ctrl[k] > spec["limit"] for k, spec in cell.limits.items() if k in ctrl), ctrl

    model = manifest.cell(root, SERVE).config["model"]
    seqs = [([3, 5, 7, 11, 13, 17, 19, 23], [1, 2, 3, 4]), ([8, 9, 10], [11, 12])]
    want = serve.reference_logits(model, seed, dev, seqs)
    fp8 = serve.reference_logits(model, seed, dev, seqs, control=True)
    chosen = [(p, [int(r.argmax()) for r in c]) for (p, _), c in zip(seqs, fp8)]
    limit = manifest.cell(root, SERVE).limits["logit_gap"]["limit"]
    assert max(serve.gaps(want, chosen, serve.top(fp8))) > limit
    exact = [(p, [int(r.argmax()) for r in w]) for (p, _), w in zip(seqs, want)]
    assert max(serve.gaps(want, exact, serve.top(want))) == 0.0
