"""The port's parallelism substrate (``repro_torch.parallel``) against the
JAX package's: rule resolution, shape-aware specs, the compile-mode knobs
and scan, the pipeline's bubble, ``shard`` without a mesh, and DTensor
placements.  The reference's tests/test_parallel.py cases run through the
port's functions; CPU only, no process group.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import resolve_divisibility_spec
from torch.distributed.tensor import Replicate, Shard

from repro.parallel import compile_mode as ref_cm
from repro.parallel import sharding as ref_sh
from repro.parallel.pipeline import bubble_fraction as ref_bubble
from repro_torch.models import attention as attn
from repro_torch.parallel import compile_mode
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.pipeline import bubble_fraction


class FakeMesh:
    """Duck-typed mesh for spec resolution (no devices, no process group):
    the reference's test mesh."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self._sizes = sizes

    @property
    def devices(self):
        class A:
            shape = tuple(self._sizes.values())
        return A()


MESH = FakeMesh({"data": 16, "model": 16})
POD = FakeMesh({"pod": 2, "data": 16, "model": 16})


def _ref_spec(spec):
    """A reference PartitionSpec as the port's tuple."""
    return tuple(spec)


LOGICAL = [
    ("batch", "seq", "heads", "head_dim"),
    ("batch", "kv_seq", "kv_heads", "head_dim"),  # first occurrence wins
    ("batch",),  # 'pod' absent from the single-pod mesh
    ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    ("vocab", "embed"),
    ("experts", "embed", "expert_mlp"),
    ("batch", "seq_chunks", None, "ssm_heads", None),
    (None, "mlp"),
]


@pytest.mark.parametrize("preset", ["default", "sp", "decode"])
@pytest.mark.parametrize("mesh", [MESH, POD], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("axes", LOGICAL, ids=lambda a: "-".join(map(str, a)))
def test_logical_to_spec_matches_reference(axes, mesh, preset):
    rules = {**sh.DEFAULT_RULES, **sh.PRESETS[preset]}
    ref_rules = {**ref_sh.DEFAULT_RULES, **ref_sh.PRESETS[preset]}
    assert sh.logical_to_spec(axes, rules, mesh) == _ref_spec(
        ref_sh.logical_to_spec(axes, ref_rules, mesh))


def test_rule_tables_are_the_reference_s():
    assert sh.DEFAULT_RULES == ref_sh.DEFAULT_RULES
    assert sh.PRESETS == ref_sh.PRESETS
    assert set(sh.PRESETS) == {"default", "sp", "decode"}


@pytest.mark.parametrize("case", [
    ((1, 128, 32768, 8, 128),
     ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
     (None, "data", "model", None, None)),  # kv_heads 8 over model=16
    ((50280, 1024), ("vocab", "embed"), (None, "data")),  # odd vocab
    ((3, 4096), ("batch", "mlp"), (None, "model")),
])
def test_shape_aware_specs(case):
    shape, axes, want = case
    got = sh.shape_aware_spec_tree({"x": torch.empty(shape, device="meta")},
                                   {"x": axes}, mesh=MESH)["x"]
    assert got == want == resolve_divisibility_spec(shape, axes)


@pytest.mark.parametrize("dim", [1, 15, 16, 17, 256, 1000, 4096])
def test_divisibility_invariant(dim):
    got = sh.shape_aware_spec_tree([torch.empty((dim,), device="meta")],
                                   [("mlp",)], mesh=MESH)[0]
    assert got == resolve_divisibility_spec((dim,), ("mlp",))
    assert got == (("model",) if dim % 16 == 0 else (None,))


def test_divisible_prefix_of_a_tuple_mapping():
    """('pod', 'data') on a batch of 2: pod kept, data dropped; of 32: both."""
    for batch, want in ((2, "pod"), (32, ("pod", "data")), (1, None)):
        got = sh.shape_aware_spec_tree(
            (torch.empty((batch, 8), device="meta"),), (("batch", None),),
            mesh=POD)[0]
        assert got == (want, None)


def test_spec_tree_maps_tuples_and_nesting():
    tree = {"a": ("batch", "mlp"), "b": [("vocab", "embed"), None],
            "kv": (("layers", "batch"), ("layers", "kv_seq"))}
    got = sh.spec_tree(tree, mesh=MESH)
    assert got == {"a": ("data", "model"), "b": [("model", "data"), ()],
                   "kv": ((None, "data"), (None, "model"))}


def _mesh(**sizes):
    """A DeviceMesh's names and shape, all that placements read (no
    process group here)."""
    return SimpleNamespace(mesh_dim_names=tuple(sizes),
                           shape=tuple(sizes.values()))


def test_to_placements():
    mesh = _mesh(data=16, model=16)
    assert sh.to_placements(("data", None, "model"), mesh) == (
        Shard(0), Shard(2))
    assert sh.to_placements((None, None), mesh) == (Replicate(), Replicate())
    # an axis of one splits nothing
    assert sh.to_placements(("data", None, "model"),
                            _mesh(data=1, model=16)) == (Replicate(), Shard(2))
    pod = _mesh(pod=2, data=16, model=16)
    assert sh.to_placements((("pod", "data"), "model"), pod) == (
        Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="mesh's axis order"):
        sh.to_placements((("data", "pod"),), pod)


def test_shard_is_identity_without_mesh():
    x = torch.ones((4, 4))
    assert sh.shard(x, "batch", "mlp") is x
    assert sh.current_mesh() is None


def test_shard_leaves_plain_tensors_under_a_mesh():
    x = torch.ones((4, 4))
    with sh.axis_rules(mesh=MESH):
        assert sh.shard(x, "batch", "mlp") is x


def test_axis_rules_context_restores():
    before = dict(sh.current_rules())
    with sh.axis_rules({"seq": "model"}, mesh=MESH):
        assert sh.current_rules()["seq"] == "model"
        assert sh.current_rules()["batch"] == ("pod", "data")
        assert sh.current_mesh() is MESH
    assert sh.current_rules() == before
    assert sh.current_mesh() is None


def test_zeros_without_mesh():
    z = sh.zeros((2, 3), torch.bfloat16, "cpu", "batch", "mlp")
    assert z.dtype == torch.bfloat16 and not z.any()


@pytest.mark.parametrize("unroll", [False, True])
def test_scan_matches_lax_scan(unroll):
    """The port's scan (a Python loop; the unroll flag changes nothing in
    an eager trace) against the reference's jax.lax.scan, rolled and
    unrolled."""
    xs = np.arange(8.0, dtype=np.float32)
    with ref_cm.compile_options(unroll_scans=unroll):
        c_ref, ys_ref = ref_cm.scan(lambda c, x: (c + x, c * x),
                                    jnp.float32(0), jnp.asarray(xs))
    with compile_mode.compile_options(unroll_scans=unroll):
        assert compile_mode.scan_unroll_flag() is unroll
        c, ys = compile_mode.scan(lambda c, x: (c + x, c * x),
                                  torch.tensor(0.0), torch.from_numpy(xs))
    assert float(c) == float(c_ref)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(ys_ref))
    assert not compile_mode.scan_unroll_flag()


def test_scan_trees_and_no_ys():
    c, ys = compile_mode.scan(lambda c, x: (c + x["a"], {"b": 2 * x["a"]}),
                              0, {"a": torch.arange(3)})
    assert int(c) == 3 and ys["b"].tolist() == [0, 2, 4]
    assert compile_mode.scan(lambda c, x: (c + 1, None), 0, None,
                             length=5) == (5, None)
    with compile_mode.unrolled_scans():
        assert compile_mode.scan_unroll_flag()


def test_flash_block_knob():
    assert compile_mode.flash_block_size() == ref_cm.flash_block_size() == 512
    with compile_mode.compile_options(flash_block=2048):
        assert compile_mode.flash_block_size() == 2048
    assert compile_mode.flash_block_size() == 512


def test_flash_attention_reads_the_knob():
    """models/attention.py's plain flash takes its KV block from the knob
    (a block that does not divide the keys is refused), and the block does
    not change the result beyond float32 rounding."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 8, 4, 16), generator=g) for _ in range(3))
    want = attn.attention_ref(q, k, v, causal=True)
    for blk in (2, 4, 8):
        with compile_mode.compile_options(flash_block=blk):
            got = attn.flash_attention(q, k, v, causal=True)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    with compile_mode.compile_options(flash_block=3):
        with pytest.raises(ValueError, match="multiple of the block 3"):
            attn.flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("m,s", [(1, 1), (8, 4), (64, 4), (3, 2)])
def test_bubble_fraction(m, s):
    assert bubble_fraction(m, s) == ref_bubble(m, s)
    assert bubble_fraction(64, 4) < bubble_fraction(8, 4)
