"""The port's sharding rules as data (``repro_torch/sharding.py``,
``launch/mesh.py``, ``launch/shardings.py``) held against the JAX
package's: for every leaf of every arch's param tree, under both
production meshes (duck-typed, as ``tests/test_sharding.py``'s
``_FakeMesh``) with ``serve_tp`` and ``seq_parallel`` off and on, the
port's spec tuple equals ``tuple(PartitionSpec)`` of JAX's; the same for
the decode state's specs, ``sanitize_spec`` and ``batch_spec`` over every
arch x shape.  Shapes come from ``jax.eval_shape`` (no allocation) and
the port's meta tensors; nothing is compiled."""

import jax
import pytest
import torch

from repro import opt as jopt
from repro import sharding as jsharding
from repro.configs import get_config as jget_config
from repro.launch import shardings as jshardings
from repro.models import build_model as jbuild_model
from repro_torch import opt, sharding
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings
from repro_torch.models import build_model


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread (the suite's parallel
    workers each start torch)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeMesh:
    """Duck-typed mesh: .axis_names + .shape mapping (enough for specs)."""

    def __init__(self, shape: dict):
        self._shape = dict(shape)

    @property
    def axis_names(self):
        return tuple(self._shape)

    @property
    def shape(self):
        return self._shape


MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
FLAGS = [dict(serve_tp=False, seq_parallel=False),
         dict(serve_tp=True, seq_parallel=True)]


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)


def _jax_flat(tree):
    """A JAX tree's leaves by '/'-joined path (the port's flat keys)."""
    return {_key(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _port_flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def jax_params():
    """Each arch's JAX param tree as ShapeDtypeStructs."""
    return {a: jax.eval_shape(jbuild_model(jget_config(a)).init,
                              jax.random.PRNGKey(0))
            for a in ASSIGNED_ARCHS}


def test_production_and_local_mesh_descriptors():
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert single.axis_names == ("data", "model")
    assert dict(single.shape) == {"data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    assert tmesh.mesh_num_chips(single) == 256
    assert tmesh.mesh_num_chips(multi) == 512
    assert tmesh.data_axis_size(single) == 16
    assert tmesh.data_axis_size(multi) == 32
    assert tmesh.model_axis_size(multi) == 16
    local = tmesh.make_local_mesh(4, 4, device="cpu")
    assert dict(local.shape) == {"data": 1, "model": 1}
    assert tmesh.mesh_num_chips(local) == 1
    assert local.devices[0, 0] == torch.device("cpu")


@pytest.mark.parametrize("flags", FLAGS, ids=["flags_off", "flags_on"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_specs_equal_jax_for_every_leaf(jax_params, mesh_name, flags):
    mesh = _FakeMesh(MESHES[mesh_name])
    for arch in ASSIGNED_ARCHS:
        params = build_model(get_config(arch)).like()
        with jopt.flags(**flags), opt.flags(**flags):
            want = {k: tuple(v) for k, v in _jax_flat(
                jsharding.param_specs(jax_params[arch], mesh)).items()}
            got = sharding.param_specs(params, mesh)
            # and sanitized (what the JAX dry-run places)
            want_s = {k: tuple(v) for k, v in _jax_flat(
                jshardings.sanitize_tree(
                    jax_params[arch],
                    jsharding.param_specs(jax_params[arch], mesh),
                    mesh)).items()}
            got_s = shardings.param_specs_for(params, mesh)
            moments = shardings.opt_state_specs(params, mesh)
        assert set(got) == set(want), arch
        for k in want:
            assert got[k] == want[k], (arch, k, got[k], want[k])
            assert got_s[k] == want_s[k], (arch, k, got_s[k], want_s[k])
        assert moments.step == () and moments.mu == got_s == moments.nu


def test_leaf_rules_and_logical_axes_equal_jax():
    assert sharding._PARAM_RULES == jsharding._PARAM_RULES
    assert sharding._REPLICATED_SUFFIXES == jsharding._REPLICATED_SUFFIXES
    assert sharding._LOGICAL == jsharding._LOGICAL
    for mesh_name, shape in MESHES.items():
        mesh = _FakeMesh(shape)
        for flags in FLAGS:
            with jopt.flags(**flags), opt.flags(**flags):
                for logical in list(sharding._LOGICAL):
                    assert (sharding.physical_axes(logical, mesh)
                            == jsharding.physical_axes(logical, mesh))
                axes = ("batch", "seq_sp", "embed", "heads", None)
                assert sharding.logical_to_spec(*axes, mesh=mesh) == tuple(
                    jsharding.logical_to_spec(*axes, mesh=mesh))
    assert sharding.logical_to_spec("batch") == ()     # no mesh: P()
    assert sharding.logical_to_spec(
        "batch", "ff", mesh=_FakeMesh(MESHES["pod16x16"])) == ("data", "model")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_state_and_batch_specs_equal_jax(arch, mesh_name):
    """Every decode and prefill shape's state (with the dry-run's
    long-context window), and every shape's inputs."""
    from repro_torch.launch.dryrun import LONG_SKIP, LONG_WINDOW
    mesh = _FakeMesh(MESHES[mesh_name])
    jcfg, cfg = jget_config(arch), get_config(arch)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    for name, shape in SHAPES.items():
        jbatch = jmodel.input_specs(shape)
        batch = model.input_specs(shape)
        for k, v in batch.items():
            assert shardings.batch_spec(mesh, v.shape[0], v.dim()) == tuple(
                jshardings.batch_spec(mesh, jbatch[k].shape[0],
                                      len(jbatch[k].shape))), (arch, name, k)
        if shape.kind == "train" or (name == "long_500k"
                                     and arch in LONG_SKIP):
            continue
        window = (LONG_WINDOW.get(arch) if name == "long_500k"
                  and shape.kind == "decode" else None)
        kw = {} if window is None else {"window": window}
        jstate = jmodel.state_specs(shape.global_batch, shape.seq_len, **kw)
        state = model.state_specs(shape.global_batch, shape.seq_len, window)
        jspecs = jshardings.state_specs(jstate, jcfg, mesh)
        want = {k: tuple(v) for k, v in _jax_flat(jspecs).items()}
        want_s = {k: tuple(v) for k, v in _jax_flat(
            jshardings.sanitize_tree(jstate, jspecs, mesh)).items()}
        got = _port_flat(shardings.state_specs(state, cfg, mesh))
        got_s = _port_flat(shardings.state_specs_sanitized(state, cfg, mesh))
        assert got == want, (arch, name)
        assert got_s == want_s, (arch, name)


def test_sanitize_spec_and_batch_spec_cases():
    mesh = _FakeMesh(MESHES["pod16x16"])
    P = jax.sharding.PartitionSpec
    cases = [(("model", "data"), (51865, 512)),
             (("model", "data"), (64000, 4096)),
             ((("data", "model"), None), (512, 4)),
             ((("data", "model"), None), (100, 4)),
             (("data",), (32, 7, 9))]
    for spec, shape in cases:
        assert shardings.sanitize_spec(spec, shape, mesh) == tuple(
            jshardings.sanitize_spec(P(*spec), shape, mesh))
    for b in (1, 8, 16, 128, 256):
        for m in MESHES.values():
            fm = _FakeMesh(m)
            assert shardings.batch_spec(fm, b, 2) == tuple(
                jshardings.batch_spec(fm, b, 2))
