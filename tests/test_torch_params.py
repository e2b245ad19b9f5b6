"""tpuflow3d_torch.params against tpuflow3d.params: the same fields and
defaults (two deliberate differences), level shapes, presets and
ValueErrors; and the from_reference mapping."""

import dataclasses
import typing

import pytest
import torch

from tpuflow3d import params as ref
from tpuflow3d_torch import params as port

torch.set_num_threads(2)

# The port's two deliberate differences from the reference.
BACKENDS = {"xla": "plain", "pallas": "kernels", "auto": "auto"}


def test_fields_and_defaults_match_reference():
    rf = [(f.name, f.default) for f in dataclasses.fields(ref.FlowParams)]
    pf = [(f.name, f.default) for f in dataclasses.fields(port.FlowParams)]
    assert [n for n, _ in rf] == [n for n, _ in pf]
    differ = {n for (n, a), (_, b) in zip(rf, pf) if a != b}
    assert differ == {"sweep_layout"}
    assert port.FlowParams().sweep_layout == "flat"
    assert typing.get_args(port.Backend) == ("auto", "plain", "kernels")


SHAPES = [(64, 64, 64), (30, 32, 32), (33, 17, 65), (7, 9, 11),
          (256, 256, 256), (31, 100, 8), (13, 64, 64)]


@pytest.mark.parametrize("name", sorted(ref.PRESETS))
def test_presets_and_level_shapes_match(name):
    rp, pp = ref.PRESETS[name], port.PRESETS[name]
    assert sorted(port.PRESETS) == sorted(ref.PRESETS)
    assert port.from_reference(rp) == pp.replace(sweep_layout="packed")
    for zm in (None, 3, 8):
        r = rp if zm is None else rp.replace(z_multiple=zm)
        p = pp if zm is None else pp.replace(z_multiple=zm)
        for shape in SHAPES:
            assert p.level_shapes(shape) == r.level_shapes(shape), (zm, shape)
    assert pp.aa_sigma() == rp.aa_sigma()
    assert pp.jacobi_omega() == rp.jacobi_omega()


BAD = [dict(scale_factor=0.0), dict(scale_factor=0.96), dict(omega=2.0),
       dict(omega=0.0), dict(levels=0), dict(alpha=0.0), dict(gamma=-1.0),
       dict(z_multiple=0), dict(sweeps=0), dict(warps=0),
       dict(inner_iterations=0), dict(sweep_layout="x"), dict(deriv_order=3),
       dict(interp="cubic"), dict(solver="cg"),
       dict(solver="multigrid", mg_cycles=0),
       dict(solver="multigrid", mg_pre=-1),
       dict(solver="multigrid", mg_cycles=30),
       dict(solver="multigrid", mg_omega=2.0)]


@pytest.mark.parametrize("kw", BAD, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_same_value_errors(kw):
    with pytest.raises(ValueError) as er:
        ref.FlowParams(**kw)
    with pytest.raises(ValueError) as ep:
        port.FlowParams(**kw)
    assert str(ep.value) == str(er.value)


def test_port_backend_names_checked():
    for bad in ("xla", "pallas", "cuda"):
        with pytest.raises(ValueError, match="backend"):
            port.FlowParams(backend=bad)


@pytest.mark.parametrize("ref_backend", sorted(BACKENDS))
def test_from_reference_round_trip(ref_backend):
    rp = ref.FlowParams(alpha=0.02, levels=3, warps=2, flow_clamp=2.0,
                        residual_tol=1e-5, median=False, backend=ref_backend)
    pp = port.from_reference(rp)
    assert pp.backend == BACKENDS[ref_backend]
    assert port.from_reference(dataclasses.asdict(rp)) == pp
    fields = dataclasses.asdict(pp)
    assert {k: v for k, v in fields.items() if k != "backend"} == \
        {k: v for k, v in dataclasses.asdict(rp).items() if k != "backend"}
    back = {v: k for k, v in BACKENDS.items()}
    assert ref.FlowParams(**{**fields, "backend": back[pp.backend]}) == rp
