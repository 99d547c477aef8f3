"""The single-scene trainer's loss keys against the JAX trainer's: each key
that JAX's ``Trainer.compute_losses`` reads is either computed by the port's
or refused by name when the trainer is built. JAX's keys are read from its
source (neuralsim_tpu/training/trainer.py), not typed in here."""
import ast
import pathlib

import pytest

from neuralsim_torch.renderers.single_volume import SingleVolumeRenderer
from neuralsim_torch.training.trainer import NOT_PORTED_LOSSES, Trainer

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the keys the port's compute_losses computes
COMPUTED = ("rgb", "occupancy_mask", "mask_entropy", "lidar", "eikonal", "sparsity",
            "clearance", "flow", "dynamic_sparsity")


def _jax_loss_keys():
    """The string keys that JAX's ``compute_losses`` looks up in
    ``self.loss_cfgs``: ``"k" in self.loss_cfgs``, ``self.loss_cfgs["k"]``,
    ``self.loss_cfgs.get("k")`` and ``any(k in self.loss_cfgs for k in
    (...))``."""
    tree = ast.parse((ROOT / "neuralsim_tpu" / "training" / "trainer.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "compute_losses")
    is_cfgs = lambda n: isinstance(n, ast.Attribute) and n.attr == "loss_cfgs"
    keys = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Compare) and any(is_cfgs(c) for c in n.comparators):
            if isinstance(n.left, ast.Constant):
                keys.add(n.left.value)
        elif isinstance(n, ast.Subscript) and is_cfgs(n.value) \
                and isinstance(n.slice, ast.Constant):
            keys.add(n.slice.value)
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "get" and is_cfgs(n.func.value) \
                and isinstance(n.args[0], ast.Constant):
            keys.add(n.args[0].value)
        elif isinstance(n, ast.GeneratorExp) and isinstance(n.elt, ast.Compare) \
                and any(is_cfgs(c) for c in n.elt.comparators):
            for gen in n.generators:
                if isinstance(gen.iter, (ast.Tuple, ast.List)):
                    keys.update(e.value for e in gen.iter.elts if isinstance(e, ast.Constant))
    return keys


def test_jax_source_is_read():
    keys = _jax_loss_keys()
    assert {"rgb", "flow", "dynamic_sparsity", "sdf_curvature", "s3im"} <= keys
    assert len(keys) >= 17


def test_every_jax_loss_key_is_computed_or_refused():
    keys = _jax_loss_keys()
    assert keys <= set(COMPUTED) | set(NOT_PORTED_LOSSES), \
        sorted(keys - set(COMPUTED) - set(NOT_PORTED_LOSSES))
    assert not set(COMPUTED) & set(NOT_PORTED_LOSSES)


@pytest.mark.parametrize("key", NOT_PORTED_LOSSES)
def test_trainer_refuses_a_loss_it_does_not_compute(key):
    renderer = SingleVolumeRenderer(param_keys={"cr": "Main"})
    with pytest.raises(NotImplementedError, match=f"the {key} loss is not ported"):
        Trainer(renderer, {"rgb": {"w": 1.0}, key: {"w": 0.1}})


@pytest.mark.parametrize("key", COMPUTED)
def test_trainer_takes_a_loss_it_computes(key):
    Trainer(SingleVolumeRenderer(param_keys={"cr": "Main"}), {key: {"w": 0.1}})
