"""BPR's epoch variants in the port (``implicit_tpu_torch/models/bpr.py``):
the grouped pool modes at the fit level against the JAX package's, and
``chip_smoke.py`` phase 11's bars at a small shape on the CPU. The epoch-level parity with the JAX functions is in
``tests/test_torch_bpr.py``.
"""

import numpy as np
import pytest
import torch

from implicit_tpu.models import bpr as jax_bpr
from implicit_tpu_torch.bpr import BayesianPersonalizedRanking
from implicit_tpu_torch.models import bpr

torch.set_num_threads(2)


@pytest.mark.parametrize("epoch_mode", ["grouped_pool", "grouped_pool_ids"])
def test_variant_precision_close_to_jax_on_clustered_set(epoch_mode):
    """The pool modes: the mean p@10 over four seeds within 0.03 of the JAX
    package's, as for the default epoch."""
    from implicit_tpu.evaluation import precision_at_k as jax_precision_at_k
    from implicit_tpu_torch.datasets.synthetic import get_synthetic_clustered
    from implicit_tpu_torch.evaluation import precision_at_k, train_test_split

    likes = get_synthetic_clustered(users=600, items=240, groups=8, likes_per_user=16, seed=7)
    train, test = train_test_split(likes, train_percentage=0.8, random_state=19)
    kw = dict(factors=31, iterations=60, learning_rate=0.05, epoch_mode=epoch_mode)
    got, want = [], []
    for seed in range(4):
        jmodel = jax_bpr.BayesianPersonalizedRanking(**kw, random_state=seed)
        jmodel.fit(train, show_progress=False)
        model = BayesianPersonalizedRanking(**kw, random_state=seed, device="cpu")
        model.fit(train, show_progress=False)
        want.append(jax_precision_at_k(jmodel, train, test, K=10, show_progress=False))
        got.append(precision_at_k(model, train, test, K=10, show_progress=False))
    assert min(got) > 0.5 and abs(np.mean(got) - np.mean(want)) <= 0.03, (got, want)


# -- chip_smoke.py phase 11's bars, at a small shape on the CPU ----------------------


def test_chip_smoke_variant_epoch_bars():
    """Phase 11's host-draw step: each pool-mode epoch on "the card" (here
    the CPU) against the CPU gives the same values, and the bar rejects the
    result with a chunk left out (the check raises otherwise)."""
    import chip_smoke

    out = chip_smoke.variant_epoch_check("cpu")
    assert set(out) == {"pool 2", "pool 1"}
    for err, wrong_err in out.values():
        assert err == 0.0 and wrong_err > 1e-5


def test_chip_smoke_variant_fit_bars(monkeypatch):
    """Phase 11's fits: every variant fits, the repeat through
    ``BPR_GROUPED`` gives the same bits, recommend serves; the module flag
    is restored afterwards, also when a fit fails."""
    import chip_smoke
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(2048, 1100, 20_000, seed=3).astype(np.float32)
    secs = chip_smoke.variant_fits(plays, "cpu", dict(bpr_grouped=1.0, bpr_sampled=1.0),
                                   factors=8)
    assert set(secs) == {tag for tag, _ in chip_smoke.BPR_VARIANTS}
    assert all(s > 0 for s in secs.values())
    assert bpr.BPR_GROUPED == 1

    def fail(*args, **kwargs):
        if bpr.BPR_GROUPED == 2:  # the repeat, through the module flag
            raise RuntimeError("the fit failed")
        return grouped_epoch(*args, **kwargs)

    grouped_epoch = bpr._bpr_epoch_grouped
    monkeypatch.setattr(bpr, "_bpr_epoch_grouped", fail)
    with pytest.raises(RuntimeError, match="the fit failed"):
        chip_smoke.variant_fits(plays, "cpu", dict(bpr_grouped=1.0, bpr_sampled=1.0),
                                factors=8)
    assert bpr.BPR_GROUPED == 1
