"""Platform rules: GPU-only measurement paths, no platform-named defaults."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from echoseal_tpu.ops.polar import polar_spec


def test_gpu_info_refuses_cpu():
    from echoseal_tpu.utils.device import gpu_info

    with pytest.raises(RuntimeError, match="no GPU"):
        gpu_info()


def test_chip_smoke_device_check_fails_on_cpu():
    import chip_smoke

    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main(["--four"])


def test_bench_device_check_fails_on_cpu(capsys):
    import bench

    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()
    assert capsys.readouterr().out == ""       # no number printed


def test_defaults_do_not_follow_backend_name(monkeypatch):
    """Table dtype and SCL formulation are the same whatever the backend."""
    from echoseal_tpu.models.robust import resolve_table_dtype
    from echoseal_tpu.ops.scl import scl_decode

    monkeypatch.delenv("ECHOSEAL_SCL_IMPL", raising=False)
    monkeypatch.delenv("ECHOSEAL_SCL_DEEP_SEG", raising=False)
    llr = jnp.zeros((2, 1024), jnp.float32)
    spec = polar_spec()

    def snapshot():
        jax.clear_caches()
        return (resolve_table_dtype(None),
                str(jax.make_jaxpr(lambda x: scl_decode(x, spec, 4))(llr)))

    base = snapshot()
    for name in ("gpu", "cuda"):
        monkeypatch.setattr(jax, "default_backend", lambda n=name: n)
        assert snapshot() == base, name
    monkeypatch.undo()
    jax.clear_caches()
    assert base[0] == jnp.float32


@pytest.fixture
def gpu():
    """The first GPU device; skips where JAX finds none (decided here,
    never at import or collection time)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: run on the card with "
                    "`JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`")


@pytest.mark.gpu
def test_payload_llr_gpu_matches_cpu(gpu, rng):
    """The XLA:GPU fusion of the LLR chain against the CPU, at v2 width."""
    from echoseal_tpu.ops.demod import payload_llr

    chips = (rng.standard_normal((32768, 1215)) * 0.3 + 0.2).astype(np.float32)
    pn = (2.0 * rng.integers(0, 2, (32768, 1024)) - 1.0).astype(np.float32)
    fn = jax.jit(payload_llr)
    on_gpu = np.asarray(fn(jax.device_put(chips, gpu),
                           jax.device_put(pn, gpu)))
    cpu = jax.devices("cpu")[0]
    on_cpu = np.asarray(fn(jax.device_put(chips, cpu),
                           jax.device_put(pn, cpu)))
    # f32 row reductions over 1024 lanes in another order: ~1e-6 relative
    np.testing.assert_allclose(on_gpu, on_cpu, rtol=1e-4, atol=1e-4)
