"""The port's public surface against the JAX package's.

Every module of ``parallax_tpu`` (the Pallas kernels ``ops/pallas_*``
aside) is imported with its counterpart in ``parallax_tpu_torch``, and:

* every public top-level name the JAX module defines (``def``, ``class``,
  assignment; read from its source, so names it merely imports are not
  counted) exists in the port's module;
* every public member of each public class (methods, properties, fields,
  and the members the JAX module attaches after the class body) exists on
  the port's class;
* every name a JAX ``__init__`` imports or assigns can be imported from the
  port's ``__init__``, a module where JAX's is a module and not one where
  JAX's is not.

What the port lacks on purpose is listed once, in ``EXCEPTIONS``, each
entry with its reason; an entry that no longer excuses anything fails
the test.  Three values are held too: ``KIND_NAMES`` and ``aabb``,
``RolledCircleWorld.lane_valid`` for 8, 9 and 48 balls at every offset,
and ``LanderState.terrain_view`` on the same reset state.
"""

import ast
import dataclasses
import fnmatch
import importlib
import pkgutil
import types

import numpy as np
import pytest
import torch
from torch_jax_states import jax_state_of

import parallax_tpu
from parallax_tpu.engine import rolled as jrolled
from parallax_tpu.envs import billiards as jbilliards
from parallax_tpu.envs import lunar_lander as jlander
from parallax_tpu.geometry import shapes as jshapes
from parallax_tpu_torch.engine import rolled
from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
from parallax_tpu_torch.envs.lunar_lander import LanderState, LunarLander
from parallax_tpu_torch.geometry import shapes
from parallax_tpu_torch.utils import checkpoint, convert
from parallax_tpu_torch.utils.pytree import tree_leaves, tree_map

_DO_NOT_PORT = "TPU or flax only: ROADMAP.md's \"Do not port\" list"
_RENAMED = "renamed: the port's kernels are CUDA, so the switch is use_cuda_*"
_HOOK = ("a private plane hook the JAX module attaches to its env class after the "
         "class body; the port defines it as the class's method")

# JAX name -> (the port's counterpart, asserted to exist, or None; reason).
# A name is "module:name" or "module:Class.member"; fnmatch patterns allowed.
EXCEPTIONS = {
    "parallax_tpu.parallel.mesh:batch_sharding": (
        None, f"{_DO_NOT_PORT}: a NamedSharding over the world mesh; the port places "
              "shards explicitly (parallel.mesh.shard_batch)"),
    "parallax_tpu.parallel:batch_sharding": (
        None, f"{_DO_NOT_PORT}: the re-export of parallel.mesh.batch_sharding"),
    "parallax_tpu.utils.pytree:static_field": (
        None, f"{_DO_NOT_PORT}: a flax struct field; the port's states are NamedTuples"),
    "parallax_tpu.utils:static_field": (
        None, f"{_DO_NOT_PORT}: the re-export of utils.pytree.static_field"),
    "parallax_tpu.utils.pytree:frozen": (
        None, f"{_DO_NOT_PORT}: a flax struct decorator; the port's states are NamedTuples"),
    "parallax_tpu.parallel:rollout": (
        "parallax_tpu_torch.parallel.rollout:rollout",
        "JAX's per-world rollout function shadows its module's name in parallel/__init__; "
        "the port keeps parallel.rollout the module (parallax_tpu_torch/parallel/__init__.py)"),
    "parallax_tpu.engine.world:WorldConfig.use_pallas_solver": (
        "parallax_tpu_torch.engine.world:WorldConfig.use_cuda_solver", _RENAMED),
    "parallax_tpu.engine.world:WorldConfig.use_pallas_fused": (
        "parallax_tpu_torch.engine.world:WorldConfig.use_cuda_fused", _RENAMED),
    "parallax_tpu.envs.lunar_lander:LanderConfig.use_pallas_fused": (
        "parallax_tpu_torch.envs.lunar_lander:LanderConfig.use_cuda_fused", _RENAMED),
    "parallax_tpu.envs.billiards:BilliardsConfig.use_pallas_fused": (
        "parallax_tpu_torch.envs.billiards:BilliardsConfig.use_cuda_fused", _RENAMED),
    "parallax_tpu.envs.robocup:RoboCupConfig.use_pallas_fused": (
        "parallax_tpu_torch.envs.robocup:RoboCupConfig.use_cuda_fused", _RENAMED),
    "parallax_tpu.utils.profiling:steps_per_second": (
        None, "best-of-N timing, which no benchmark, check or documented operator reads: the "
              "benchmark (portbench/) measures rates itself over its whole window"),
    "parallax_tpu.envs.lunar_lander:_lander_*": (None, _HOOK),
    "parallax_tpu.envs.billiards:_bl_plane_*": (None, _HOOK),
    "parallax_tpu.envs.robocup:_rc_plane_*": (None, _HOOK),
}

JAX_MODULES = ["parallax_tpu"] + sorted(
    m.name for m in pkgutil.walk_packages(parallax_tpu.__path__, "parallax_tpu.")
    if not m.name.startswith("parallax_tpu.ops.pallas_")
)
PACKAGES = [m for m in JAX_MODULES if importlib.import_module(m).__file__.endswith("__init__.py")]


def port_name(name):
    return "parallax_tpu_torch" + name[len("parallax_tpu"):]


def excused(qual):
    """The ``EXCEPTIONS`` key that matches ``qual``, or None."""
    return next((k for k in EXCEPTIONS if fnmatch.fnmatchcase(qual, k)), None)


def has_member(cls, name):
    fields = getattr(cls, "__dataclass_fields__", {})
    return hasattr(cls, name) or name in fields or name in getattr(cls, "__annotations__", {})


def resolve(ref):
    """``"module:name"`` or ``"module:Class.member"`` -> whether it exists."""
    mod, _, path = ref.partition(":")
    obj = importlib.import_module(mod)
    head, _, member = path.partition(".")
    if not hasattr(obj, head):
        return False
    return has_member(getattr(obj, head), member) if member else True


def source_tree(module):
    with open(module.__file__) as f:  # an empty __init__ has no source for inspect
        return ast.parse(f.read())


def defined_names(module):
    """Top-level names ``module``'s source defines, and for each class the
    names its body defines."""
    tree = source_tree(module)
    top, members = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            top.add(node.name)
        if isinstance(node, ast.ClassDef):
            members[node.name] = {
                t.id for b in node.body
                for t in (b.targets if isinstance(b, ast.Assign) else [getattr(b, "target", None)])
                if isinstance(t, ast.Name)
            } | {b.name for b in node.body if isinstance(b, ast.FunctionDef)}
        for t in node.targets if isinstance(node, ast.Assign) else [getattr(node, "target", None)]:
            if isinstance(t, ast.Name) and isinstance(node, (ast.Assign, ast.AnnAssign)):
                top.add(t.id)
    return top, members


def surface_gaps(name):
    """``(missing qualified names, the exception keys they used)`` of one
    JAX module against its port."""
    jmod, pmod = importlib.import_module(name), importlib.import_module(port_name(name))
    top, members = defined_names(jmod)
    missing, used = [], set()

    def need(qual, ok):
        key = excused(qual)
        if key is not None:
            used.add(key)
        elif not ok:
            missing.append(qual)

    hooks = {}  # private functions the module attaches to a class: name -> (class, member)
    for cname in members:
        for member, value in vars(getattr(jmod, cname)).items():
            if isinstance(value, types.FunctionType) and value.__name__ != member \
                    and value.__name__ in top:
                hooks[value.__name__] = (cname, member)
    for n in sorted(top):
        if n in hooks:
            cname, member = hooks[n]
            need(f"{name}:{n}", has_member(getattr(pmod, cname, object), member))
        elif not n.startswith("_"):
            need(f"{name}:{n}", hasattr(pmod, n))
    for cname, body in members.items():
        if cname.startswith("_") or not hasattr(pmod, cname):
            continue
        attached = {m for m, v in vars(getattr(jmod, cname)).items()
                    if getattr(v, "__module__", None) == name}  # not flax's replace
        public = {m for m in body | attached if not m.startswith("_")}
        for m in sorted(public):
            need(f"{name}:{cname}.{m}", has_member(getattr(pmod, cname), m))
    return missing, used


def export_gaps(name):
    """The same for a package's ``__init__``: every name it imports or
    assigns, importable from the port's, of the same kind (module or not)."""
    jmod, pmod = importlib.import_module(name), importlib.import_module(port_name(name))
    tree = source_tree(jmod)
    exported = {a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom)
                for a in n.names}
    exported |= {t.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets}
    missing, used = [], set()
    for n in sorted(exported):
        qual = f"{name}:{n}"
        key = excused(qual)
        if key is not None:
            used.add(key)
            continue
        j, p = getattr(jmod, n), getattr(pmod, n, None)
        if p is None or isinstance(j, types.ModuleType) != isinstance(p, types.ModuleType):
            missing.append(qual)
    return missing, used


@pytest.mark.parametrize("name", JAX_MODULES)
def test_module_surface_has_counterparts(name):
    missing, _ = surface_gaps(name)
    assert not missing, f"{port_name(name)} lacks {missing}"


@pytest.mark.parametrize("name", PACKAGES)
def test_init_exports_importable_from_port(name):
    missing, _ = export_gaps(name)
    assert not missing, f"{port_name(name)}/__init__.py does not export {missing}"


def test_exception_table_is_live():
    """Each exception excuses some JAX name, and its counterpart exists."""
    used = set()
    for name in JAX_MODULES:
        used |= surface_gaps(name)[1]
    for name in PACKAGES:
        used |= export_gaps(name)[1]
    assert used == set(EXCEPTIONS), f"stale entries: {sorted(set(EXCEPTIONS) - used)}"
    for key, (counterpart, reason) in EXCEPTIONS.items():
        assert reason
        assert counterpart is None or resolve(counterpart), f"{key}: no {counterpart}"


def test_kind_names_and_aabb_match_jax():
    assert shapes.KIND_NAMES == jshapes.KIND_NAMES
    got, want = shapes.aabb((-1.0, -0.5), (2.0, 0.25)), jshapes.aabb((-1.0, -0.5), (2.0, 0.25))
    assert got.kind == want.kind == shapes.BOX and got.radius == want.radius
    np.testing.assert_array_equal(got.verts, np.asarray(want.verts))
    assert shapes.aabb is shapes.box


def test_lane_valid_matches_jax():
    """``lane_valid(d)`` for 8, 9 and 48 balls at every offset: only the
    even ``nb``'s offset ``nb/2`` masks its second half."""
    port_w = Billiards(BilliardsConfig(rolled=True), device="cpu")._rolled_world
    jax_w = jbilliards.Billiards(jbilliards.BilliardsConfig(rolled=True))._rolled_world
    assert isinstance(jax_w, jrolled.RolledCircleWorld)
    assert isinstance(port_w, rolled.RolledCircleWorld)
    for nb in (8, 9, 48):
        pw, jw = dataclasses.replace(port_w, n_balls=nb), dataclasses.replace(jax_w, n_balls=nb)
        assert list(pw.offsets) == list(jw.offsets)
        for d in pw.offsets:
            got, want = pw.lane_valid(d), jw.lane_valid(d)
            assert isinstance(got, np.ndarray) and got.dtype == bool and got.shape == (nb,)
            np.testing.assert_array_equal(got, want)
        assert (~pw.lane_valid(nb // 2)).any() == (nb % 2 == 0)


def test_terrain_view_matches_jax(tmp_path):
    """``LanderState.terrain_view`` against JAX's on the same reset state
    (B=4); the property is no field: ``_replace``, ``tree_map`` and a
    checkpoint round trip see JAX's six fields."""
    env = LunarLander(device="cpu")
    st = env.reset_fn_batch(torch.tensor([[0, 1], [2, 3], [4, 5], [6, 7]]))
    jst = jax_state_of(jlander.LanderState, convert.lander_state_to_numpy(st))
    assert st.terrain_view.shape == jst.terrain_view.shape == (4, 7, jshapes.MAX_VERTS, 2)
    np.testing.assert_array_equal(st.terrain_view.numpy(), np.asarray(jst.terrain_view))
    assert LanderState._fields == tuple(jlander.LanderState.__dataclass_fields__)
    assert len(tree_leaves(st)) == 9  # the 4 body fields and the other 5
    moved = tree_map(lambda x: x + 0, st._replace(t=st.t + 1))
    assert type(moved) is LanderState and torch.equal(moved.terrain_view, st.terrain_view)
    checkpoint.save(str(tmp_path / "st.pt"), st)
    back = checkpoint.restore(str(tmp_path / "st.pt"), st)
    assert type(back) is LanderState
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(st)))
