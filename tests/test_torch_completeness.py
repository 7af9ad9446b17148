"""The port covers the JAX package: an `ast` walk of both packages'
sources (neither package is imported).

Every public function and class at the top level of a `vinsat_tpu/`
module has a counterpart in `vinsat_tpu_torch/`, in one of three ways:
  * the same name defined at the top level of the port's module of the
    same path;
  * an entry of RENAMED, a counterpart under another name or module;
  * an entry of NOT_PORTED, with the reason it is left out.
Every `pl.pallas_call` site of the JAX package lies in a function of
KERNELS, whose hand-written CUDA source exists and is bound by the port's
wrapper module.  Each map names only code that exists, so a stale entry
fails as a missing counterpart does.
"""
import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "vinsat_tpu", ROOT / "vinsat_tpu_torch"

# "module:name" of the JAX package -> "module:name" of its counterpart in
# the port (module paths relative to each package)
RENAMED = {
    # config.py's dataclasses: the port keeps their values where the JAX
    # hot path reads them
    "config.py:CameraConfig": "config.py:REFERENCE_INTRINSICS",
    "config.py:DynamicsConfig": "estimation/ba.py:SolverParams",
    "config.py:SolverConfig": "estimation/ba.py:SolverParams",
    "config.py:GatingConfig": "estimation/ingest.py:gate_and_compact",
    "config.py:WindowConfig": "estimation/ingest.py:split_windows",
    "config.py:InitNoiseConfig": "estimation/window.py:StreamingConfig",
    "config.py:SimConfig": "pipeline.py:simulate_sequence",
    "config.py:PipelineConfig": "estimation/window.py:StreamingConfig",
    "dist/bench_scaling.py:build_problem": "dist/launch.py:synthetic_problem",
    "dist/launch.py:init_worker": "dist/mesh.py:init_distributed",
    # the kernels' wrappers and their plain twins
    "kernels/tridiag_pallas.py:block_tridiag_solve_pallas":
        "kernels/tridiag_pcr.py:block_tridiag_solve_pcr",
    "kernels/normal_eq.py:assemble_normal_eq_reference":
        "kernels/normal_eq.py:assemble_normal_eq_plain",
    "kernels/matching.py:visible_count": "kernels/visible_count.py:"
                                         "visible_count",
    "kernels/matching.py:visible_count_reference":
        "kernels/visible_count.py:visible_count_plain",
    # utils/mfu: the card's peaks, counted operations and bytes, the LM
    # stages and their timer
    "utils/mfu.py:chip_peaks": "utils/mfu.py:card_peaks",
    "utils/mfu.py:compiled_cost": "utils/mfu.py:count",
    "utils/mfu.py:time_call": "utils/mfu.py:_time_ms",
}

# "module:name" of the JAX package (a module alone: all of it) -> why the
# port leaves it out
NOT_PORTED = {
    "utils/cache.py": "the JAX compile cache",
    "utils/checkpoint.py:save_orbax": "Orbax checkpoints JAX pytrees; the "
                                      "port's npz carries the JAX keys",
    "utils/checkpoint.py:load_orbax": "Orbax checkpoints JAX pytrees; the "
                                      "port's npz carries the JAX keys",
    "estimation/ba.py:_pcr_capable": "the TPU test of the XLA dispatch",
    "dist/mesh.py:orbit_sharding": "a NamedSharding helper; the port's "
                                   "Mesh lays shards out as a dimension",
    "dist/mesh.py:arc_sharding": "a NamedSharding helper; the port's Mesh "
                                 "lays shards out as a dimension",
    "dist/mesh.py:batch_arc_sharding": "a NamedSharding helper; the port's "
                                       "Mesh lays shards out as a dimension",
}

# the JAX function holding each pallas_call -> (the port's wrapper module,
# its CUDA source in kernels/csrc)
KERNELS = {
    "kernels/tridiag_pallas.py:block_tridiag_solve_pallas":
        ("kernels/tridiag_pcr.py", "tridiag_pcr"),
    "kernels/normal_eq.py:assemble_normal_eq":
        ("kernels/normal_eq.py", "normal_eq"),
    "kernels/matching.py:visible_count":
        ("kernels/visible_count.py", "visible_count"),
}


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _defined(package: pathlib.Path, module: str) -> set:
    """The names a module defines at its top level (def, class,
    assignment), and "Class.method" for its classes' methods; empty for a
    missing module."""
    path = package / module
    if not path.exists():
        return set()
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{n.name}" for n in node.body
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return names


# module-level assignments that make a function: `solve_window =
# jax.jit(_solve_window, ...)` is as public as a def
_TRANSFORMS = ("jax.jit", "jax.vmap", "jax.pmap", "functools.partial")


def _public(module: str) -> list:
    """The public functions and classes of a JAX module, in order: its
    defs and classes, and its names bound to a JAX transform's result."""
    names = []
    for node in _tree(JAX / module).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif (isinstance(node, ast.Assign)
              and isinstance(node.value, ast.Call)
              and ast.unparse(node.value.func) in _TRANSFORMS):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_")]


def _modules() -> list:
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _split(key: str):
    module, _, name = key.partition(":")
    return module, name


def test_every_public_jax_name_has_a_counterpart():
    missing = []
    for module in _modules():
        if module in NOT_PORTED:
            continue
        port = _defined(PORT, module)
        for name in _public(module):
            key = f"{module}:{name}"
            if name not in port and key not in RENAMED \
                    and key not in NOT_PORTED:
                missing.append(key)
    assert not missing, missing


def test_renamed_counterparts_exist():
    bad = []
    for key, target in RENAMED.items():
        module, name = _split(key)
        t_module, t_name = _split(target)
        # the JAX name exists, the port lacks it under that name (else the
        # entry is needless), and the counterpart exists
        if (name not in _defined(JAX, module)
                or name in _defined(PORT, module)
                or t_name not in _defined(PORT, t_module)):
            bad.append(key)
    assert not bad, bad


def test_not_ported_entries_name_jax_code():
    bad = []
    for key, reason in NOT_PORTED.items():
        module, name = _split(key)
        if not name:
            ok = (JAX / module).exists() and not (PORT / module).exists()
        else:
            ok = (name in _defined(JAX, module)
                  and name not in _defined(PORT, module))
        if not (ok and reason):
            bad.append(key)
    assert not bad, bad


def _pallas_sites() -> set:
    """"module:function" of every top-level function holding a
    `pallas_call`."""
    sites = set()
    for module in _modules():
        for node in _tree(JAX / module).body:
            if any(isinstance(n, ast.Attribute) and n.attr == "pallas_call"
                   for n in ast.walk(node)):
                sites.add(f"{module}:{getattr(node, 'name', '?')}")
    return sites


def test_every_pallas_call_has_a_cuda_counterpart():
    assert _pallas_sites() == set(KERNELS)
    for wrapper, source in KERNELS.values():
        assert (PORT / "kernels" / "csrc" / f"{source}.cu").exists()
        # the wrapper binds csrc/<source>.cu through _build.Entry
        assert f'_build.Entry("{source}"' in (PORT / wrapper).read_text()
