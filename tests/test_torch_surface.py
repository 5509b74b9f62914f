"""The port's surface against the JAX package's, read from both packages'
sources with ``ast`` (this file imports neither jax nor torch):

(a) every module of the JAX package has a port module at the same relative
    path;
(b) every public top-level function, class and assigned name of a JAX
    module, every public method of those classes, and every parameter of
    those functions and methods has a same-named counterpart in the mirror
    module (a class's methods include those it inherits from port classes),
    or an entry in ``EXCEPTIONS``;
(c) every ``FESR_*`` knob the JAX package reads (a string literal) is read
    by the port too, or is in ``EXCEPTIONS``;
(d) no port module raises ``NotImplementedError`` naming ROADMAP.md.

Each entry of ``EXCEPTIONS`` gives the reason and, where one exists, the
port name that takes its place; the test checks that the replacement exists
and that the JAX name still lacks its counterpart, so the table cannot rot.
Read this file before choosing to skip or drop something in the port: a
difference belongs here only when it is PyTorch idiom (state in the
``nn.Module``, no interpret mode, no named mesh axes, JAX's jit and vmap
closures), never to get past a missing behaviour.
"""

import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "fast_eng_super_resolution_tpu"
PORT_PKG = REPO / "fast_eng_super_resolution_tpu_torch"

# Parameters that exist only because of JAX's functional style or the TPU,
# wherever they appear.
JAX_ONLY_ARGS = {
    "params": "the weights live in the nn.Module (self)",
    "opt_state": "Adam's state lives in the torch optimizer",
    "interpret": "no interpret mode: a kernel wrapper runs its plain version "
                 "on CPU tensors and launches the kernel on CUDA ones",
    "fused_interpret": "as 'interpret'",
    "axis": "torch.distributed has no named mesh axes",
    "sub": "the Pallas kernel's inner tile; the Hopper kernels tile "
           "themselves",
}

# (kind, module, name[, argument]) -> (replacement or None, reason).
# kind 'name': a public name of a JAX module (``Class.method`` for a
# method); the replacement is a port name in the mirror module, or
# 'path.py:name' in another port module.  kind 'arg': a parameter of a JAX
# function or method; the replacement is a parameter of the port's
# counterpart.  kind 'knob': an FESR_* variable; the replacement is another
# knob the port reads.
EXCEPTIONS = {
    # init/apply become the module's construction and forward
    **{("name", mod, f"{cls}.{m}"): (repl, "init/apply: the nn.Module's "
                                     "construction (init_params) and forward")
       for mod, cls, m, repl in (
           ("models/deeponet.py", "DeepONet", "init", "DeepONet.init_params"),
           ("models/deeponet.py", "AdaptDeepONet", "init",
            "AdaptDeepONet.init_params"),
           ("models/fno.py", "FNO1d", "init", "FNO1d.init_params"),
           ("models/fno.py", "FNO2d", "init", "FNO2d.init_params"),
           ("models/fno.py", "FNO3d", "init", "FNO3d.init_params"),
           ("models/graphsage.py", "GraphSAGE", "init",
            "GraphSAGE.init_params"),
           ("models/kernelnn.py", "KernelNN", "init", "KernelNN.init_params"),
           ("models/teecnet.py", "TEECNet", "init", "TEECNet.init_params"),
           ("models/powerseries.py", "PowerSeriesKernel", "init",
            "PowerSeriesKernel.init_params"),
           ("models/powerseries.py", "PowerSeriesKernel", "apply",
            "PowerSeriesKernel.forward"))},
    ("name", "models/common.py", "linear"): (
        None, "a parameter dict's x @ w + b: nn.Linear's forward"),
    ("name", "models/common.py", "mlp_init"): (
        "mlp_layers", "an MLP's parameter dicts: an nn.ModuleList of "
        "nn.Linear (initialised by its model's init_params)"),
    # JAX's jit closures and device-array helpers
    ("name", "data/reconstruct.py", "make_overlap_average_device"): (
        "overlap_average_device", "a jit factory: the port calls the "
        "function directly"),
    ("name", "ops/interpolate.py", "gaussian_interpolate_device_jit"): (
        "gaussian_interpolate_device", "the jitted form of the function"),
    ("name", "physics/amg.py", "split_levels"): (
        "make_vcycle", "splits the hierarchy into jit-static and traced "
        "parts; the port's make_vcycle takes the levels as they are"),
    ("name", "physics/amg.py", "make_vcycle_fn"): (
        "make_vcycle", "a jit factory over split_levels' parts"),
    ("name", "parallel/dispatch.py", "make_routed_apply"): (
        "routed_apply", "a vmapped apply over stacked experts: the port "
        "runs each label group through its own expert (on purpose, "
        "ROADMAP.md section C, routing)"),
    ("name", "parallel/dispatch.py", "stack_params"): (
        "routed_apply", "stacks the experts' parameter trees for the vmap; "
        "the port keeps one module per expert"),
    ("name", "parallel/dispatch.py", "select_expert"): (
        "routed_apply", "slices one expert out of the stacked trees"),
    ("name", "ops/fused_conv.py", "to_device_s"): (
        "expand_s", "uploads the compact S generators and expands them with "
        "a jit; the port moves a CompactS with .to(device) and expands it "
        "with expand_s"),
    ("name", "ops/fused_conv.py", "to_device_s_stacked"): (
        "expand_s", "to_device_s over a leading device axis"),
    ("name", "ops/pallas_mp.py", "pallas_available"): (
        None, "a TPU backend probe: the port decides by the operands' "
        "device (a CUDA tensor launches the kernel, a CPU one runs the "
        "plain version)"),
    ("name", "ops/message_passing.py", "Mode"): (
        "MODES", "a typing.Literal alias; the port checks the tuple MODES"),
    ("name", "utils/env.py", "setup_compilation_cache"): (
        "ops/fused_conv.py:build_kernel", "XLA's persistent compilation "
        "cache; the port's counterpart is the nvcc library cache under "
        "_build/"),
    # parameters
    ("arg", "core/graph.py", "stack_graphs", "to_device"): (
        None, "the port returns host arrays; Graph.to_torch(device) moves "
        "them"),
    ("arg", "core/graph.py", "pad_and_bucket", "to_device"): (
        None, "as stack_graphs"),
    ("arg", "models/common.py", "linear_init", "key"): (
        "generator", "a PRNG key: a torch.Generator"),
    ("arg", "models/common.py", "linear_init", "c_in"): (
        "layer", "the nn.Linear carries its shape"),
    ("arg", "models/common.py", "linear_init", "c_out"): (
        "layer", "the nn.Linear carries its shape"),
    ("arg", "models/common.py", "pyg_uniform_init", "key"): (
        "generator", "a PRNG key: a torch.Generator"),
    ("arg", "models/common.py", "pyg_uniform_init", "shape"): (
        "param", "fills the given parameter in place"),
    ("arg", "models/kernelnn.py", "KernelNN.__init__", "remat"): (
        None, "jax.checkpoint of each layer, an XLA scheduling knob that "
        "changes no result"),
    ("arg", "models/teecnet.py", "TEECNet.__init__", "remat"): (
        None, "as KernelNN's"),
    ("arg", "ops/loss.py", "compute_node_weight", "num_nodes"): (
        None, "JAX's function is per graph and vmapped by its scheduler; "
        "the port's takes the [B] axis, and the node count is pred's"),
    ("arg", "ops/segment.py", "masked_segment_sum", "indices_are_sorted"): (
        None, "an XLA scatter-lowering hint; index_add_ reads no order"),
    ("arg", "ops/segment.py", "masked_segment_mean", "indices_are_sorted"): (
        None, "as masked_segment_sum's"),
    ("arg", "parallel/grid_train.py", "GridTrainer.init", "key"): (
        "seed", "a PRNG key: a seed for a torch.Generator"),
    ("arg", "parallel/train.py", "Trainer.init", "key"): (
        "seed", "a PRNG key: a seed for a torch.Generator"),
    ("arg", "parallel/train.py", "Trainer.epoch", "stacked"): (
        "batches", "a list of batches or one stacked tree"),
    ("arg", "parallel/train.py", "Trainer.__init__", "donate"): (
        None, "XLA buffer donation"),
    ("arg", "sched/scheduler.py", "PartitionScheduler.__init__",
     "use_mesh"): (
        "mesh", "a flag to build JAX's device mesh; the port takes the "
        "torch.distributed group's Mesh (or builds it when one is up)"),
    **{("arg", "ops/fused_conv.py", fn, "s_matrix"): (
        "s", "S's name in the port (dense or CompactS)")
       for fn in ("fused_edge_conv", "fused_edge_conv_bwd",
                  "fused_edge_conv_ad", "fused_edge_conv_lowrank",
                  "fused_edge_conv_lowrank_ad")},
    **{("arg", "ops/fused_conv.py", fn, "xe_impl"): (
        None, "picks one of B1's two Pallas bodies ('repeat', 'gemm') for "
        "the TPU's layout; the Hopper B1 has one design (FESR_FUSED_XE)")
       for fn in ("fused_edge_conv", "fused_edge_conv_bwd")},
    # knobs
    ("knob", "FESR_FUSED_XE"): (
        None, "a TPU layout choice between two Pallas bodies of B1; the "
        "Hopper B1 has one design"),
    ("knob", "FESR_COMPILE_CACHE"): (
        None, "the directory of XLA's compilation cache "
        "(setup_compilation_cache); the port caches nvcc libraries under "
        "_build/"),
}


def _modules(pkg: pathlib.Path) -> dict:
    return {p.relative_to(pkg).as_posix(): p for p in sorted(pkg.rglob("*.py"))
            if "_build" not in p.parts}


JAX_MODULES = _modules(JAX_PKG)
PORT_MODULES = _modules(PORT_PKG)


def _top_level(tree: ast.Module):
    """The module's top-level statements, those under a top-level
    if/try included."""
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, ast.If):
            todo += node.body + node.orelse
        elif isinstance(node, ast.Try):
            todo += node.body + node.orelse + node.finalbody
            for h in node.handlers:
                todo += h.body
        else:
            yield node


def _args(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [v.arg for v in (a.vararg, a.kwarg) if v is not None]
    return [n for n in names if n not in ("self", "cls")]


def _surface(path: pathlib.Path) -> tuple:
    """(names, args, classes) of one module: every top-level name and
    ``Class.member``; the parameters of each function and method
    (``Class.__init__``: a dataclass's fields); each class's bases and
    members."""
    tree = ast.parse(path.read_text(), str(path))
    names, args, classes = set(), {}, {}
    for node in _top_level(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            args[node.name] = _args(node)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            members, fields = set(), []   # fields: a dataclass's
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members.add(item.name)
                    args[f"{node.name}.{item.name}"] = _args(item)
                elif isinstance(item, ast.AnnAssign) and isinstance(
                        item.target, ast.Name):
                    fields.append(item.target.id)
                elif isinstance(item, ast.Assign):
                    members.update(t.id for t in item.targets
                                   if isinstance(t, ast.Name))
            if fields and "__init__" not in members:
                args[f"{node.name}.__init__"] = fields
            bases = [b.id if isinstance(b, ast.Name) else
                     b.attr if isinstance(b, ast.Attribute) else None
                     for b in node.bases]
            classes[node.name] = (bases, members | set(fields))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return names, args, classes


PORT_SURFACE = {rel: _surface(p) for rel, p in PORT_MODULES.items()}
PORT_CLASSES = {}
for _rel, (_, _, _classes) in sorted(PORT_SURFACE.items()):
    for _name, _cls in _classes.items():
        PORT_CLASSES.setdefault(_name, []).append(_cls)


def _members(cls_name: str, own) -> set:
    """A port class's members with those of its port base classes."""
    out, todo, seen = set(), [own], set()
    while todo:
        bases, members = todo.pop()
        out |= members
        for b in bases:
            if b and b not in seen:
                seen.add(b)
                todo += PORT_CLASSES.get(b, [])
    return out


def _port_has(rel: str, name: str) -> bool:
    """Whether port module ``rel`` has ``name`` (a top-level name or
    ``Class.member``)."""
    if rel not in PORT_SURFACE:
        return False
    names, _, classes = PORT_SURFACE[rel]
    if "." not in name:
        return name in names
    cls, member = name.split(".", 1)
    return cls in classes and member in _members(cls, classes[cls])


def _port_args(rel: str, qual: str):
    """The port counterpart's parameters (an inherited method's too), or
    None when it is no function the source defines."""
    _, args, classes = PORT_SURFACE[rel]
    if qual in args:
        return args[qual]
    if "." in qual:
        cls, member = qual.split(".", 1)
        if cls in classes:
            for b in classes[cls][0]:
                for rel2, (_, args2, classes2) in PORT_SURFACE.items():
                    if b in classes2 and f"{b}.{member}" in args2:
                        return args2[f"{b}.{member}"]
    return None


def _public(qual: str) -> bool:
    parts = qual.split(".")
    return not any(p.startswith("_") for p in parts[:-1]) and (
        not parts[-1].startswith("_") or parts[-1] == "__init__")


def _gaps(rel: str) -> set:
    """The JAX module's surface that the port module lacks: ('name', rel,
    name) and ('arg', rel, function, argument) keys."""
    names, args, classes = _surface(JAX_MODULES[rel])
    gaps = set()
    for name in names:
        if _public(name) and not _port_has(rel, name):
            gaps.add(("name", rel, name))
    for cls, (_, members) in classes.items():
        # a dataclass's fields are held as its __init__'s parameters below
        for m in members - set(args.get(f"{cls}.__init__", ())):
            qual = f"{cls}.{m}"
            if _public(cls) and _public(qual) and m != "__init__" and \
                    not _port_has(rel, qual):
                gaps.add(("name", rel, qual))
    for qual, jargs in args.items():
        if not _public(qual) or ("name", rel, qual) in gaps \
                or ("name", rel, qual.split(".")[0]) in gaps:
            continue
        pargs = _port_args(rel, qual)
        if pargs is None:
            continue
        gaps.update(("arg", rel, qual, a) for a in jargs
                    if a not in pargs and a not in JAX_ONLY_ARGS)
    return gaps


def _knobs(modules: dict) -> set:
    out = set()
    for p in modules.values():
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and re.fullmatch(r"FESR_[A-Z0-9_]+", node.value):
                out.add(node.value)
    return out


JAX_KNOBS = sorted(_knobs(JAX_MODULES))
PORT_KNOBS = _knobs(PORT_MODULES)


def test_every_jax_module_has_a_port_module():
    missing = sorted(set(JAX_MODULES) - set(PORT_MODULES))
    assert len(JAX_MODULES) > 50 and not missing, missing


@pytest.mark.parametrize("rel", sorted(JAX_MODULES))
def test_module_surface_has_counterparts(rel):
    """Every public name, method and parameter of the JAX module has its
    counterpart in the port module, or an entry in EXCEPTIONS."""
    unexplained = sorted(g for g in _gaps(rel) if g not in EXCEPTIONS)
    assert not unexplained, unexplained


def test_exceptions_are_live_and_name_real_replacements():
    """Each entry names a gap that still exists (a JAX name or parameter
    the port lacks, a knob the port does not read) and, where it gives
    one, a replacement the port has."""
    gaps = set().union(*(_gaps(rel) for rel in JAX_MODULES))
    for key, (repl, reason) in EXCEPTIONS.items():
        assert reason, key
        kind = key[0]
        if kind == "knob":
            assert key[1] in JAX_KNOBS and key[1] not in PORT_KNOBS, key
            assert repl is None or repl in PORT_KNOBS, key
            continue
        assert key in gaps, f"{key}: not a gap (ported since?)"
        if repl is None:
            continue
        if kind == "name":
            rel, name = repl.split(":") if ":" in repl else (key[1], repl)
            assert _port_has(rel, name), (key, repl)
        else:
            assert repl in (_port_args(key[1], key[2]) or ()), (key, repl)


@pytest.mark.parametrize("knob", JAX_KNOBS)
def test_fesr_knob_is_read_by_the_port(knob):
    assert knob in PORT_KNOBS or ("knob", knob) in EXCEPTIONS, knob


def test_no_port_module_refuses_naming_the_roadmap():
    """No ``raise NotImplementedError(... ROADMAP.md ...)`` is left: the
    port's refusals of unported work are gone."""
    found = []
    for rel, p in PORT_MODULES.items():
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Raise) and node.exc is not None:
                text = ast.unparse(node.exc)
                if "NotImplementedError" in text and "ROADMAP" in text:
                    found.append((rel, node.lineno))
    assert not found, found
