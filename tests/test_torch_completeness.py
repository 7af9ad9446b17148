"""The port covers the JAX package: an `ast` walk of both packages'
sources (neither package is imported).

Every public function and class at the top level of a `vinsat_tpu/`
module has a counterpart in `vinsat_tpu_torch/`, in one of three ways:
  * the same name defined at the top level of the port's module of the
    same path;
  * an entry of RENAMED, a counterpart under another name or module;
  * an entry of NOT_PORTED, with the reason it is left out.
Every public function and method of the JAX package that has a
counterpart takes the same parameters there: each JAX parameter has a
parameter of the same name in the counterpart, the parameters the two share
come in JAX's relative order, and where both give a default the defaults
are equal, unless an entry of PARAMS says otherwise (the port's name for
the parameter, or why it is left out or defaults otherwise).
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

_KEY = "`key` (a JAX PRNG key) becomes a torch.Generator"
_SEED = "`key` (a JAX PRNG key) becomes the int numpy draws from"
_INTERPRET = "Pallas interpret mode; a CUDA kernel has none"
_BUCKET = "JAX's recompile bucket; eager torch needs none"
_F64 = ("the port rolls orbits out in f64 always (JAX's f32 fallback "
        "applies only with x64 off)")

# "module:function:parameter" of the JAX package (a method as
# "module:Class.method:parameter") -> how its counterpart in the port
# differs there.  A value whose text up to its first ":" is an identifier
# is the port's name for the parameter ("dtype"), followed, where the
# defaults differ, by ": why".  Any other value is a reason: why the port
# leaves the parameter out, or why a parameter it keeps under JAX's name
# has another default.
PARAMS = {
    # random draws: torch generators, or the ints numpy draws from
    "pipeline.py:track_landmark_db:key": "seed",
    "sim/landmarks.py:synthesize:key": "seed",
    # a torch.Generator, or the DetectionDraws one made
    "sim/detections.py:generate_detections:key": "draws",
    "sim/orbits.py:sample_polar_oe:key": "generator",
    "sim/orbits.py:sample_iss_like_oe:key": "generator",
    "sim/orbits.py:sample_random_oe:key": "generator",
    "sim/orbits.py:generate_trajectory:key": "generator",
    "sim/orbits.py:generate_constellation:key": "generator",
    "sim/imagery.py:make_landmark_templates:key": "generator",
    "sim/imagery.py:render_region_image:key": "generator",
    "sim/imagery.py:render_region_u8:key": "generator",
    "sim/learned_detector.py:make_training_batch:key": "generator",
    "sim/learned_detector.py:train_detector:key": "generator",
    # kernel selection and TPU tiling
    "sim/detections.py:generate_detections:use_pallas_gate":
        "kernel selection: the port's gate is K3 on a card, its plain twin "
        "on the CPU",
    "kernels/matching.py:visible_count:interpret": _INTERPRET,
    "kernels/normal_eq.py:assemble_normal_eq:interpret": _INTERPRET,
    "kernels/tridiag_pallas.py:block_tridiag_solve_pallas:interpret":
        _INTERPRET,
    "kernels/matching.py:nearest_landmark:tile": "TPU tiling of the scan",
    "pipeline.py:simulate_sequence:device_sim":
        "the JAX switch between host and device simulation; the port "
        "simulates on `device`",
    # JAX's recompile buckets
    "estimation/hybrid.py:ekf_refine_window:pad_to": _BUCKET,
    "estimation/refine.py:refine_terminal:knot_bucket": _BUCKET,
    "estimation/refine.py:refine_terminal:obs_bucket": _BUCKET,
    # jax devices and mesh axes
    "dist/mesh.py:make_mesh:devices":
        "a jax device list; the port's Mesh is shards on one `device`, or "
        "on the ranks of a process `group`",
    "dist/mesh.py:make_mesh:n_orbit":
        "JAX's None reads its device list; the port has none to read",
    "dist/mesh.py:make_mesh:n_arc":
        "JAX's None reads its device list; the port has none to read",
    "dist/tridiag.py:sharded_block_tridiag_solve:axis":
        "the port's Mesh has one arc axis, a tensor dimension",
    # dtypes
    "sim/orbits.py:generate_trajectory:dtype": _F64,
    "sim/orbits.py:generate_constellation:dtype": _F64,
    "utils/mfu.py:stage_programs:dtype":
        "the port's stages are eager: no program per dtype",
    "estimation/ingest.py:process_ground_truths:device_dtype":
        "dtype: JAX's None is its backend's default, f64 under x64; the "
        "port names f64",
    "utils/mfu.py:measure:dtype_str":
        "dtype: a torch dtype in place of its name",
    "utils/mfu.py:measure:repeats": "a count of timing runs",
    # utils/mfu's renamed helpers take the card's terms
    "utils/mfu.py:chip_peaks:device": "name",
    "utils/mfu.py:compiled_cost:jitted": "fn",
    "utils/mfu.py:time_call:*args": "args",
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


def _signatures(tree: ast.Module) -> dict:
    """name -> [(parameter, default's source or None)] of a module's
    top-level functions, its classes' methods ("Class.method") and its
    names bound to a transform of one of its functions (functools.partial
    drops the parameters it binds).  Varargs are "*name" / "**name"."""
    defs = {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    def params(fn):
        a = fn.args
        pos = a.posonlyargs + a.args
        out = list(zip([p.arg for p in pos],
                       [None] * (len(pos) - len(a.defaults))
                       + [ast.unparse(d) for d in a.defaults]))
        if a.vararg:
            out.append((f"*{a.vararg.arg}", None))
        out += [(p.arg, None if d is None else ast.unparse(d))
                for p, d in zip(a.kwonlyargs, a.kw_defaults)]
        if a.kwarg:
            out.append((f"**{a.kwarg.arg}", None))
        return out

    sigs = {name: params(fn) for name, fn in defs.items()}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            sigs.update({f"{node.name}.{m.name}": params(m)
                         for m in node.body
                         if isinstance(m, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))})
        elif (isinstance(node, ast.Assign)
              and isinstance(node.value, ast.Call)
              and ast.unparse(node.value.func) in _TRANSFORMS
              and node.value.args
              and isinstance(node.value.args[0], ast.Name)
              and node.value.args[0].id in defs):
            call = node.value
            sig = params(defs[call.args[0].id])
            if ast.unparse(call.func) == "functools.partial":
                bound = {k.arg for k in call.keywords}
                sig = [p for p in sig[len(call.args) - 1:]
                       if p[0] not in bound]
            sigs.update({t.id: sig for t in node.targets
                         if isinstance(t, ast.Name)})
    return sigs


def _constants(tree: ast.Module) -> dict:
    """name -> its value's source, for a module's top-level assignments."""
    return {t.id: ast.unparse(n.value) for n in tree.body
            if isinstance(n, ast.Assign) for t in n.targets
            if isinstance(t, ast.Name)}


def _same_default(jax_src: str, port_src: str, port_consts: dict) -> bool:
    """Whether two defaults are one value: the same source, a jnp dtype and
    the torch dtype of its name, or a port constant bound to JAX's
    source."""
    if jax_src.startswith("jnp."):
        jax_src = "torch." + jax_src[4:]
    return port_src in (jax_src,) or port_consts.get(port_src) == jax_src


def _param_findings(key: str, jax_sig: list, port_sig: list,
                    port_consts: dict, entries: dict, used: set) -> list:
    """What differs between a JAX function's parameters and its
    counterpart's (key "module:function") that no entry of `entries`
    covers; the entries read are added to `used`."""
    port_names = [n for n, _ in port_sig]
    port_default = dict(port_sig)
    found, shared = [], []
    for name, default in jax_sig:
        pkey = f"{key}:{name}"
        entry = entries.get(pkey)
        why_default = None
        if entry is None:
            if name not in port_default:
                found.append(f"{pkey}: dropped")
                continue
            counterpart = name
        else:
            used.add(pkey)
            head, colon, tail = entry.partition(":")
            if head.isidentifier():
                counterpart, why_default = head, (tail.strip() if colon
                                                  else None)
                if counterpart not in port_default or name in port_default:
                    found.append(f"{pkey}: renamed to {counterpart}, which "
                                 "the port does not have in its place")
                    continue
            elif name not in port_default:
                continue  # left out, for the entry's reason
            else:
                counterpart, why_default = name, entry
        other = port_default[counterpart]
        differs = (default is not None and other is not None
                   and not _same_default(default, other, port_consts))
        if differs and not why_default:
            found.append(f"{pkey}: default {default} in JAX, {other} in "
                         "the port")
        elif why_default and not differs:
            found.append(f"{pkey}: the entry says the default differs; "
                         "it does not")
        shared.append(counterpart)
    order = sorted(shared, key=port_names.index)
    if order != shared:
        found.append(f"{key}: the parameters both take come in the order "
                     f"{order} in the port, {shared} in JAX")
    return found


def _counterpart(module: str, name: str):
    """(module, name) of the port's counterpart of a JAX function or
    method: RENAMED's, the renamed class's method, or the same."""
    cls, dot, method = name.partition(".")
    target = RENAMED.get(f"{module}:{cls}")
    if target is None:
        return module, name
    t_module, t_name = _split(target)
    return t_module, t_name + dot + method


def _all_param_findings(entries: dict):
    """The parameter findings over every public JAX function and method
    with a counterpart that has a signature, and the entries read."""
    found, used = [], set()
    for module in _modules():
        if module in NOT_PORTED:
            continue
        public = set(_public(module))
        for name, sig in _signatures(_tree(JAX / module)).items():
            parts = name.split(".")
            if parts[0] not in public or any(p.startswith("_")
                                             for p in parts):
                continue
            if f"{module}:{name}" in NOT_PORTED \
                    or f"{module}:{parts[0]}" in NOT_PORTED:
                continue
            t_module, t_name = _counterpart(module, name)
            if not (PORT / t_module).exists():
                continue
            port_tree = _tree(PORT / t_module)
            port_sig = _signatures(port_tree).get(t_name)
            if port_sig is None:
                continue  # a counterpart without parameters (a constant)
            found += _param_findings(f"{module}:{name}", sig, port_sig,
                                     _constants(port_tree), entries, used)
    return found, used


def test_counterparts_take_jax_parameters():
    found, used = _all_param_findings(PARAMS)
    assert not found, found
    # a stale entry (its function, parameter or difference gone) fails
    assert not set(PARAMS) - used, sorted(set(PARAMS) - used)


_JAX_SOURCE = """
import jax

def window(states, prob, lamda, params=None, quat_coeff=1.0,
           vel_coeff=1.0, initialize=False):
    pass

def stream(rows, orbit, seed=0, metrics=None, path=None, resume=None):
    pass

def sample(key, n=4, dtype=None):
    pass

stream_jit = jax.jit(stream)
"""

_PORT_SOURCE = """
def window(states, prob, lamda, params=None, initialize=False,
           device="cuda"):
    pass

def stream(rows, orbit, seed=0, device="cuda", path=None, resume=None,
           metrics=None):
    pass

def sample(generator, n=8):
    pass

def stream_jit(rows, orbit, seed=0, metrics=None, path=None, resume=None):
    pass
"""


def test_param_walker_reports_drops_and_reorders():
    jax_sigs = _signatures(ast.parse(_JAX_SOURCE))
    port_tree = ast.parse(_PORT_SOURCE)
    port_sigs = _signatures(port_tree)
    entries = {"m.py:sample:key": "generator",
               "m.py:sample:dtype": "the port samples in f64"}
    found, used = [], set()
    for name in ("window", "stream", "sample", "stream_jit"):
        found += _param_findings(f"m.py:{name}", jax_sigs[name],
                                 port_sigs[name], _constants(port_tree),
                                 entries, used)
    assert sorted(found) == sorted([
        "m.py:window:quat_coeff: dropped",
        "m.py:window:vel_coeff: dropped",
        "m.py:stream: the parameters both take come in the order "
        "['rows', 'orbit', 'seed', 'path', 'resume', 'metrics'] in the "
        "port, ['rows', 'orbit', 'seed', 'metrics', 'path', 'resume'] in "
        "JAX",
        "m.py:sample:n: default 4 in JAX, 8 in the port",
    ]), found
    assert used == set(entries)
    # the jitted name takes its function's parameters; the port's stream_jit
    # matches them
    assert [n for n, _ in jax_sigs["stream_jit"]] == [
        "rows", "orbit", "seed", "metrics", "path", "resume"]
