"""TPU kernels 8-11 (the phase-1 experiments of ``benchmarks/``) against
their ports in ``iscc_search_tpu_torch.experiments`` (CPU; the Pallas
kernels run in interpret mode, the port's wrappers take their plain
versions).

- kernel 8, ``benchmarks/exp_kernels.py`` ``make_variant``: every variant
  name, its module's ``pl.pallas_call`` replaced by one that drops the TPU
  compiler parameters and sets ``interpret=True``;
- kernel 9, ``benchmarks/exp_int4.py``: JAX on the CPU refuses s4 (in
  Pallas and in a jitted ``dot_general``), so the int4 entries are held
  against the script's int8 ``dot8`` expression and its numpy reference,
  and the probe against the Pallas out_spec's column selection;
- kernel 10, ``benchmarks/exp_bitplane_int8.py`` ``make_variant`` (patched
  as kernel 8) for each mode;
- kernel 11, ``benchmarks/exp_bitplane_u8.py`` ``blockmax_subword_impl``
  with ``interpret=True``, uint8 and uint16 twins;
- every twin layout of ``ops/bitplane.py`` against its JAX original.

Inputs are numpy arrays from fixed seeds; half the queries are 192-bit
prefixes (``q_scale = 1/384``), where a score rounded once differs from one
rounded twice. Tolerance: bit-exact on every block with a valid row; the
layouts and the int4 dots are equal.
"""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from iscc_search_tpu.ops import pallas_scan as jax_pallas
from iscc_search_tpu.ops import pm1_scan as jax_pm1
from iscc_search_tpu_torch.experiments import exp_bitplane_int8 as port10
from iscc_search_tpu_torch.experiments import exp_bitplane_u8 as port11
from iscc_search_tpu_torch.experiments import exp_int4 as port9
from iscc_search_tpu_torch.experiments import exp_kernels as port8
from iscc_search_tpu_torch.ops import bitplane
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops import pm1_scan

REPO = Path(__file__).resolve().parent.parent


def _interpret_pallas_call(*args, **kwargs):
    kwargs.pop("compiler_params", None)
    kwargs["interpret"] = True
    return pl.pallas_call(*args, **kwargs)


def _script(name):
    """A module of benchmarks/, loaded from its file, its pallas_call run in
    interpret mode (the module object is private to this test file)."""
    spec = importlib.util.spec_from_file_location(f"_bench_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(pallas_call=_interpret_pallas_call, BlockSpec=pl.BlockSpec)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {name: _script(name) for name in ("exp_kernels", "exp_bitplane_int8", "exp_bitplane_u8")}


def _t(a):
    return torch.from_numpy(np.array(a))


def _queries(rng, packed_rows, nq):
    """Packed queries from database rows, half of them 192-bit prefixes:
    (JAX q_pm1, q_scale) and (port q_packed, min_lanes, q_scale)."""
    q_codes = packed_rows[rng.integers(0, len(packed_rows), nq)]
    q_lanes = np.where(np.arange(nq) < nq // 2, 8, 6).astype(np.int32)
    q_pm1, q_scale = jax_pm1.prepare_queries(q_codes, q_lanes, 256)
    min_lanes, scale = pm1_scan.query_prefix(_t(q_lanes), 256)
    assert np.array_equal(scale.numpy(), q_scale)
    return q_pm1, q_scale, (_t(q_codes.view(np.int32)), min_lanes, scale)


def _validity(rng, n):
    valid = rng.random(n) > 0.05
    valid[3 * 128 : 4 * 128] = False  # an all-invalid block
    return valid


def _assert_parity(got, want, valid, transposed=False):
    """Bit-exact on every block with a valid row."""
    live = valid.reshape(-1, 128).any(axis=1)
    got, want = (got.T, want.T) if transposed else (got, want)
    assert got.shape == want.shape and not live.all()
    np.testing.assert_array_equal(got[:, live], want[:, live])


# ------------------------------------------------------------------ layouts


@pytest.mark.parametrize("lanes", (4, 8))
def test_bit_transpose_packed_equals_jax(monkeypatch, lanes):
    monkeypatch.setattr(bitplane, "TWIN_STEP_ROWS", 4096)  # two steps
    packed = np.random.default_rng(lanes).integers(0, 2**32, (8192, lanes), dtype=np.uint32)
    got = bitplane.bit_transpose_packed(_t(packed.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (8192 * lanes // 128, 128)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(jax_pallas.bit_transpose_packed(jnp.asarray(packed))))


@pytest.mark.parametrize("width_bits", (8, 16))
def test_subword_twin_layouts_equal_jax(monkeypatch, scripts, width_bits):
    u8 = scripts["exp_bitplane_u8"]
    monkeypatch.setattr(bitplane, "TWIN_STEP_ROWS", 4096)
    rng = np.random.default_rng(width_bits)
    packed = rng.integers(0, 2**32, (8192, 8), dtype=np.uint32)
    got = bitplane.build_twin(_t(packed.view(np.int32)), width_bits).numpy()
    want = np.asarray(u8.build_twin(jnp.asarray(packed), width_bits))
    assert got.dtype == (np.uint8 if width_bits == 8 else np.int16)
    np.testing.assert_array_equal(got.view(want.dtype), want)
    np.testing.assert_array_equal(bitplane._o_map(width_bits), u8._o_map(width_bits))
    pen = rng.integers(-5, 5, 8192).astype(np.int32)
    np.testing.assert_array_equal(
        bitplane.penalty_perm(_t(pen), width_bits).numpy(), np.asarray(u8.penalty_perm(jnp.asarray(pen), width_bits))
    )


def test_bitplane_penalty_perm_and_group_equal_jax():
    pen = np.random.default_rng(3).standard_normal(8192).astype(np.float32)
    np.testing.assert_array_equal(
        bitplane.bitplane_penalty_perm(_t(pen)).numpy(), np.asarray(jax_pallas.bitplane_penalty_perm(jnp.asarray(pen)))
    )
    assert bitplane.PERM_GROUP == jax_pallas.PERM_GROUP


def test_int4_twin_nibble_order():
    """Element 2m in the low nibble of byte m, two's complement, as
    ml_dtypes stores each int4 value."""
    x = np.random.default_rng(4).integers(-8, 8, (300, 256)).astype(np.int8)
    got = bitplane.build_int4_twin(_t(x)).numpy()
    nib = x.astype(ml_dtypes.int4).view(np.uint8) & 0xF
    np.testing.assert_array_equal(got, nib[:, 0::2] | (nib[:, 1::2] << 4))
    np.testing.assert_array_equal(bitplane.unpack_int4(_t(got)).numpy(), x)


def test_layout_builders_check_their_inputs():
    with pytest.raises(ValueError, match="N % 4096"):
        bitplane.bit_transpose_packed(torch.zeros((4000, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="128/256-bit"):
        bitplane.bit_transpose_packed(torch.zeros((4096, 6), dtype=torch.int32))
    with pytest.raises(ValueError, match="256-bit"):
        bitplane.build_twin(torch.zeros((4096, 4), dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="8 or 16"):
        bitplane.build_twin(torch.zeros((4096, 8), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="even width"):
        bitplane.build_int4_twin(torch.zeros((4, 3), dtype=torch.int8))


# ------------------------------------------------------------------ kernel 8


def _kernel8_inputs(n, nq=8, seed=8):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    db = np.asarray(jax_pallas.build_unpacked_db(jnp.asarray(packed), 256, permute=False))
    q_pm1, q_scale, _ = _queries(rng, packed, nq)
    valid = _validity(rng, n)
    pen16 = np.asarray(jnp.where(jnp.asarray(valid), 0, -65536).astype(jnp.bfloat16))[None, :]
    return q_pm1.astype(np.int8), q_scale[:, None], db, valid, pen16


@pytest.mark.parametrize("name", port8.NAMES)
def test_kernel8_variant_equals_pallas(scripts, name):
    """Each variant against the script's Pallas kernel in interpret mode;
    the chunk-0 (``nodma``) and 32768-row chunk variants at two chunks."""
    n = 32768 if ("nodma" in name or name == "chunk32768") else 16384
    q, qs, db, valid, pen16 = _kernel8_inputs(n)
    fn, orient = port8.make_variant(name, n, len(q))
    want_fn, want_orient = scripts["exp_kernels"].make_variant(name, n, len(q))
    assert orient == want_orient
    if name == "u8max":
        pen = valid.astype(np.uint8)[None, :]
    else:
        pen = pen16.reshape(n, 1) if orient == "col" else pen16
    pen_t = _t(pen.view(np.int16)).view(torch.bfloat16) if pen.dtype != np.uint8 else _t(pen)
    launches = port8.blockmax_variant.launches
    got = fn(_t(q), _t(qs), _t(db), pen_t).numpy()
    assert port8.blockmax_variant.launches == launches  # the CPU takes the plain version
    want = np.asarray(want_fn(jnp.asarray(q), jnp.asarray(qs), jnp.asarray(db), jnp.asarray(pen)))
    _assert_parity(got, want, valid, transposed=orient == "col")


def test_kernel8_u8max_is_another_function(scripts):
    """``u8max`` is not ``base``: it drops the scale and halves the dot."""
    q, qs, db, valid, pen16 = _kernel8_inputs(16384)
    got = port8.make_variant("u8max", 16384, 8)[0](_t(q), _t(qs), _t(db), _t(valid.astype(np.uint8)[None, :]))
    base = port8.make_variant("bf16", 16384, 8)[0](_t(q), _t(qs), _t(db), _t(pen16.view(np.int16)).view(torch.bfloat16))
    assert float((got - base).abs().max()) > 100
    live = valid.reshape(-1, 128).any(axis=1)
    assert float(got[:, live].max()) <= 256 and float(got[:, live].min()) >= -254


def test_kernel8_names_and_checks():
    assert port8.variant_spec("chunk8192")[:2] == (port8.EPI_BF16, 8192)
    assert port8.variant_spec("consume_f32acc_nodma")[2] is True
    assert port8.variant_spec("dotonly_bf16")[0] == port8.EPI_DOTONLY_BF16
    for bad in ("nope", "chunk2048", "chunk0"):
        with pytest.raises(ValueError):
            port8.variant_spec(bad)
    with pytest.raises(ValueError, match="multiple of the 16384-row chunk"):
        port8.make_variant("bf16", 8192, 8)
    q = torch.zeros((8, 256), dtype=torch.int8)
    qs = torch.ones((8, 1))
    db = torch.zeros((16384, 256), dtype=torch.int8)
    pen = torch.zeros((1, 16384), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pen"):
        port8.blockmax_variant("u8max", q, qs, db, pen)
    with pytest.raises(ValueError, match=r"pen \(16384, 1\)"):
        port8.blockmax_variant("trans", q, qs, db, pen)
    with pytest.raises(ValueError, match="qs"):
        port8.blockmax_variant("bf16", q, qs[:, 0].contiguous(), db, pen)
    with pytest.raises(RuntimeError, match="no kernel for device type 'meta'"):
        port8.blockmax_variant("bf16", q.to("meta"), qs.to("meta"), db.to("meta"), pen.to("meta"))


def test_kernel8_launch_key_groups_the_names_of_one_launch():
    """Tiling and tree order are the TPU's: their names share the ``bf16``
    launch; the ``*_nodma`` probes read chunk 0 only and launch apart."""
    keys = {name: port8.launch_key(name) for name in port8.NAMES}
    assert {keys[n] for n in ("bf16", "sub2048", "sub8192", "tree", "chunk32768")} == {(port8.EPI_BF16, 0)}
    assert keys["trans"] == keys["tree_trans"] and keys["consume"] == keys["consume_f32acc"]
    assert keys["nodma_full"] == (port8.EPI_BF16, port8.CHUNK)
    assert keys["dotonly_nodma"] != keys["dotonly"] and keys["consume_nodma"] != keys["consume"]
    assert len(set(keys.values())) == 13


@pytest.mark.parametrize("kernel", (8, 9, 10, 11))
def test_wrappers_refuse_misaligned_queries(kernel):
    """The kernels load queries as 4-byte (int8) or 16-byte (int4) words: a
    query view off that alignment raises before any launch."""
    def view(dtype, rows, cols, offset):
        return torch.zeros(rows * cols + offset, dtype=dtype)[offset:].view(rows, cols)

    with pytest.raises(ValueError, match="aligned"):
        if kernel == 8:
            pen = torch.zeros((1, 16384), dtype=torch.bfloat16)
            port8.blockmax_variant("bf16", view(torch.int8, 8, 256, 1), torch.ones((8, 1)),
                                   torch.zeros((16384, 256), dtype=torch.int8), pen)
        elif kernel == 9:
            port9.int4_dot(view(torch.uint8, 8, 128, 4), torch.zeros((128, 128), dtype=torch.uint8))
        elif kernel == 10:
            port10.blockmax_bitplane(view(torch.int8, 4, 256, 2), torch.ones(4), torch.zeros((256, 128), dtype=torch.int32),
                                     torch.zeros((1, 4096), dtype=torch.bfloat16))
        else:
            port11.blockmax_subword(view(torch.int8, 4, 256, 3), torch.ones(4), torch.zeros((1024, 128), dtype=torch.uint8),
                                    torch.zeros((1, 4096), dtype=torch.int32), 8)


# ------------------------------------------------------------------ kernel 9


def test_kernel9_int4_dot_equals_the_int8_dot():
    """The script's ``dot8`` (:76) and numpy reference (:60) on the same
    ±1 rows; the probe keeps the Pallas out_spec's columns (rows
    ``i * 16384 + j``, j < 128)."""
    n = 32768
    rng = np.random.default_rng(0)
    db_i8 = rng.choice(np.array([-1, 1], np.int8), size=(n, 256)).astype(np.int8)
    q_i8 = db_i8[: port9.Q].copy()
    q_i8[4:, 192:] = 0  # shorter prefixes: zero nibbles
    dot8 = jax.jit(lambda q, d: jax.lax.dot_general(q, d, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32))
    ref = q_i8.astype(np.int32) @ db_i8.astype(np.int32).T
    np.testing.assert_array_equal(np.asarray(dot8(jnp.asarray(q_i8), jnp.asarray(db_i8))), ref)
    q4, db4 = bitplane.build_int4_twin(_t(q_i8)), bitplane.build_int4_twin(_t(db_i8))
    launches = port9.int4_dot.launches, port9.int4_probe.launches
    np.testing.assert_array_equal(port9.int4_dot(q4, db4).numpy(), ref)
    probe = port9.int4_probe(q4, db4).numpy()
    assert (port9.int4_dot.launches, port9.int4_probe.launches) == launches
    cols = (np.arange(n // 16384)[:, None] * 16384 + np.arange(128)).reshape(-1)
    np.testing.assert_array_equal(probe, ref[:, cols].astype(np.float32))
    np.testing.assert_array_equal(port9.int8_reference_dot(_t(q_i8), _t(db_i8)).numpy(), ref)


def test_kernel9_checks_its_inputs():
    q4 = torch.zeros((8, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="N % 128"):
        port9.int4_dot(q4, torch.zeros((100, 128), dtype=torch.uint8))
    with pytest.raises(ValueError, match="N % 16384"):
        port9.int4_probe(q4, torch.zeros((128, 128), dtype=torch.uint8))
    with pytest.raises(ValueError, match="chunk"):
        port9.int4_probe(q4, torch.zeros((128, 128), dtype=torch.uint8), chunk=100)
    with pytest.raises(ValueError, match="uint8"):
        port9.int4_dot(q4.to(torch.int8), torch.zeros((128, 128), dtype=torch.uint8))


# ------------------------------------------------------------- kernels 10-11


def _bitplane_inputs(n, seed):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    q_pm1, q_scale, port_q = _queries(rng, packed, 13)
    valid = _validity(rng, n)
    return packed, valid, q_pm1, q_scale, port_q


@pytest.mark.parametrize("mode,ppd", [("int8", 8), ("int8v2", 4), ("bf16cast", 16)])
def test_kernel10_equals_pallas_and_blockmax(scripts, mode, ppd):
    """Each mode of the script's kernel (interpret mode) on the
    ``bit_transpose_packed`` twin; on blocks with a valid row both equal
    the port's ``blockmax`` on the packed rows."""
    n, chunk = 8192, 4096
    packed, valid, q_pm1, q_scale, port_q = _bitplane_inputs(n, seed=10)
    twin = bitplane.bit_transpose_packed(_t(packed.view(np.int32)))
    penalty = jnp.where(jnp.asarray(valid), 0, -65536).astype(jnp.float32)
    pen_bp = np.asarray(jax_pallas.bitplane_penalty_perm(penalty).reshape(1, n).astype(jnp.bfloat16))
    want = np.asarray(
        scripts["exp_bitplane_int8"].make_variant(n, 13, chunk, ppd, mode)(
            jnp.asarray(q_pm1), jnp.asarray(q_scale), jnp.asarray(twin.numpy().view(np.uint32)), jnp.asarray(pen_bp)
        )
    )
    pen_t = _t(pen_bp.view(np.int16)).view(torch.bfloat16)
    got = port10.make_variant(n, 13, chunk, ppd, mode)(_t(q_pm1), _t(q_scale), twin, pen_t).numpy()
    _assert_parity(got, want, valid)
    popc = hs.blockmax(*port_q, _t(packed.view(np.int32)), _t(valid.astype(np.uint8))).numpy()
    _assert_parity(got, popc, valid)


@pytest.mark.parametrize("width_bits", (8, 16))
def test_kernel11_equals_pallas_and_blockmax(scripts, width_bits):
    """``blockmax_subword_impl`` of the script (interpret mode) and of the
    port; the int32 penalty commutes with the affine map, so the port also
    equals ``blockmax`` on every block, the all-invalid one included."""
    n = 8192
    packed, valid, q_pm1, q_scale, port_q = _bitplane_inputs(n, seed=11)
    u8 = scripts["exp_bitplane_u8"]
    jtwin = u8.build_twin(jnp.asarray(packed), width_bits)
    want = np.asarray(
        u8.blockmax_subword_impl(
            jnp.asarray(q_pm1), jnp.asarray(q_scale), jtwin, jnp.asarray(valid), width_bits, 4096, interpret=True
        )
    )
    twin = bitplane.build_twin(_t(packed.view(np.int32)), width_bits)
    launches = port11.blockmax_subword.launches
    got = port11.blockmax_subword_impl(_t(q_pm1), _t(q_scale), twin, _t(valid), width_bits, 4096).numpy()
    assert port11.blockmax_subword.launches == launches
    _assert_parity(got, want, valid)
    popc = hs.blockmax(*port_q, _t(packed.view(np.int32)), _t(valid.astype(np.uint8))).numpy()
    np.testing.assert_array_equal(got, popc)


def test_bitplane_wrappers_check_their_inputs():
    q = torch.zeros((4, 256), dtype=torch.int8)
    qs = torch.ones(4)
    twin = torch.zeros((256, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="pen"):
        port10.blockmax_bitplane(q, qs, twin, torch.zeros((1, 100), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="twin"):
        port10.blockmax_bitplane(q, qs, twin[:100], torch.zeros((1, 4096), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="int32"):
        port10.blockmax_bitplane(q, qs, twin.to(torch.int16), torch.zeros((1, 4096), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="planes_per_dot"):
        port10.make_variant(4096, 4, 4096, 3, "int8")
    with pytest.raises(ValueError, match="chunk"):
        port10.make_variant(8192, 4, 3000, 4, "int8")
    with pytest.raises(ValueError, match="8 or 16"):
        port11.blockmax_subword(q, qs, twin, torch.zeros((1, 4096), dtype=torch.int32), 32)
    with pytest.raises(ValueError, match="int16"):
        port11.blockmax_subword(q, qs, torch.zeros((512, 128), dtype=torch.uint8), torch.zeros((1, 4096), dtype=torch.int32), 16)
    with pytest.raises(ValueError, match="chunk_size"):
        port11.blockmax_subword_impl(q.float(), qs, torch.zeros((1024, 128), dtype=torch.uint8), torch.ones(4096), 8, 1000)


# ---------------------------------------------------------------- entry points


@pytest.mark.parametrize(
    "module,argv",
    [
        (port8, ["--n", "16384", "--q", "8", "base", "bf16", "tree", "trans", "u8max"]),
        (port9, ["--n", "16384"]),
        (port10, ["--n", "8192", "--q", "8"]),
        (port11, ["--n", "8192", "--q", "8"]),
    ],
)
def test_experiment_main_runs_on_the_cpu(capsys, module, argv):
    """Each entry point parses its arguments in ``main`` and runs the plain
    versions on the CPU when asked; its checks hold."""
    results = module.main([*argv, "--device", "cpu", "--reps", "1"])
    out = capsys.readouterr().out
    assert results and all(v > 0 for v in results.values())
    assert "False" not in out.replace("matches base False", "") and "cpu" in out
