"""The port's target (unlabelled) loader against the JAX package's, both
with augment=False (the device_aug route): the same weak views, labels,
masks, identity M_s records and batch order, exactly. With `with_gt` the
labels come through. With augment=True (the host route) the strong and
weak views, labels and M_s equal JAX's too."""

import numpy as np
import pytest

from efficientteacher_tpu.data import datasets_ssod as jax_ssod
from efficientteacher_torch.data import datasets_ssod as port_ssod
from test_torch_datasets import cfgs, write_dataset


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("target"), seed=4,
                         name="unlabeled")


@pytest.mark.parametrize("with_gt", [False, True])
def test_target_loader_matches_jax(target, with_gt):
    pc, jc = cfgs(target, **{"Dataset.target": target,
                             "SSOD.ssod_hyp.with_gt": with_gt})
    port = port_ssod.create_target_dataloader(pc, batch_size=3, seed=7,
                                              augment=False)
    ref = jax_ssod.create_target_dataloader(jc, batch_size=3, seed=7,
                                            augment=False)
    assert len(port) == len(ref) == 3
    for _ in range(2):  # two epochs: shuffled by seed + epoch
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 3
        for bp, bj in zip(got, want):
            assert bp["images"] is bp["images_ori"]
            np.testing.assert_array_equal(bp["images_ori"].numpy(),
                                          bj["images_ori"])
            np.testing.assert_array_equal(bp["images"].numpy(),
                                          bj["images"])
            for k in ("labels", "mask", "M_s"):
                np.testing.assert_array_equal(bp[k], bj[k], err_msg=k)
            assert list(bp["indices"]) == list(bj["indices"])
        if with_gt:
            assert any(b["mask"].any() for b in got)
        else:
            assert not any(b["mask"].any() for b in got)
    item, ref_item = port.ds[2], ref.ds[2]
    for a, b in zip(item, ref_item, strict=True):
        np.testing.assert_array_equal(a, b)


def test_target_host_augmentation_raises(target):
    """The host weak / strong pipeline is ported: augment=True gives JAX's
    batches (strong and weak views, labels, M_s); an unknown AutoAugment
    policy raises when a strong view with labels draws it."""
    pc, jc = cfgs(target, **{"Dataset.target": target,
                             "Dataset.loader": "process",
                             "SSOD.ssod_hyp.with_gt": True})
    port = port_ssod.create_target_dataloader(pc, batch_size=3, seed=7)
    ref = jax_ssod.create_target_dataloader(jc, batch_size=3, seed=7)
    for bp, bj in zip(list(port), list(ref), strict=True):
        for k in ("images", "images_ori"):
            np.testing.assert_array_equal(bp[k].numpy(), bj[k])
        for k in ("labels", "mask", "M_s"):
            np.testing.assert_array_equal(bp[k], bj[k], err_msg=k)
    assert not (bp["M_s"][:, 1:10] == np.eye(3).reshape(-1)).all()
    pc.SSOD.ssod_hyp.autoaugment = 1.0
    pc.SSOD.ssod_hyp.autoaugment_policy = "v9"
    with pytest.raises(RuntimeError, match="unknown AutoAugment policy"):
        list(port_ssod.create_target_dataloader(pc, batch_size=3, seed=7))
