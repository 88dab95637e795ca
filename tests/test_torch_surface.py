"""Every public name of the JAX package has its counterpart in the port.

Both packages are parsed, not imported. A public name of a ``fastmot_tpu``
module is a top-level function, class or assignment not starting with
``_``, and in an ``__init__.py`` also a name it re-exports; its
counterpart is any top-level binding of the same name (a definition, an
import, or a name a module ``__getattr__`` answers) in the port's module
of the same path. ``__graft_entry__``'s ``entry`` and ``dryrun_multichip``
are ``fastmot_tpu_torch/multichip.py``'s. The exceptions are listed, each
with its reason from ROADMAP.md's ground rules."""
import ast
from pathlib import Path

ROOT = Path(__file__).parents[1]
JAX, PORT = ROOT / 'fastmot_tpu', ROOT / 'fastmot_tpu_torch'

# TPU layout code the port leaves out on purpose ("Port semantics, not TPU
# layout tricks", ROADMAP.md)
EXCLUDED = {
    'ops/smallmat.py': 'the unrolled small-matrix algebra (VPU broadcast '
                       'forms); the port uses torch.linalg',
    'detector.py:PACKED_STEM': 'the phase-packed letterbox that feeds the '
                               'space-to-depth stem fold',
    'models/osnet.py:apply_fused': 'the stream-batched OSBlock routing; the '
                                   'port always runs ops.osnet_block.osblock',
    'models/osnet.py:force_batched_streams': 'the stream-batched OSBlock',
    'ops/flow_kernels.py:LK_EXTRA_STEPS': 'the 64-tap window tables of the '
                                          'TPU LK',
    'ops/flow_kernels.py:TAB_DTYPE': 'the 64-tap window tables of the TPU LK',
}
# the same function under the port's name
RENAMED = {
    'ops/osnet_block.py:osblock_fused': 'osblock',
    'parallel/streams.py:conv_channel_shardings': 'shard_conv_channels',
    'parallel/__init__.py:conv_channel_shardings': 'shard_conv_channels',
}


def _statements(body):
    """Top-level statements, looking into module-level if/try blocks."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _statements(node.body + node.orelse
                                   + getattr(node, 'finalbody', []))
        else:
            yield node


def _assigned(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [t.id for t in targets if isinstance(t, ast.Name)]


def public_names(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in _statements(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(_assigned(node))
        elif isinstance(node, ast.ImportFrom) and path.name == '__init__.py':
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith('_') and n != 'annotations'}


def bindings(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in _statements(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
            if node.name == '__getattr__':      # lazily exported names
                out.update(c.value for c in ast.walk(node)
                           if isinstance(c, ast.Constant)
                           and isinstance(c.value, str))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(_assigned(node))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split('.')[0]
                       for a in node.names)
    return out


def test_every_public_name_has_a_counterpart():
    missing, checked = [], 0
    for path in sorted(JAX.rglob('*.py')):
        rel = path.relative_to(JAX).as_posix()
        if rel in EXCLUDED:
            continue
        port = PORT / rel
        have = bindings(port) if port.exists() else set()
        for name in sorted(public_names(path)):
            key = f'{rel}:{name}'
            if key in EXCLUDED:
                continue
            checked += 1
            if RENAMED.get(key, name) not in have:
                missing.append(key)
    assert not missing, missing
    assert checked > 200


def test_graft_entry_has_its_twin():
    assert {'entry', 'dryrun_multichip'} <= \
        public_names(ROOT / '__graft_entry__.py') & \
        bindings(PORT / 'multichip.py')


def test_every_exclusion_names_something_real():
    for key in [*EXCLUDED, *RENAMED]:
        rel, _, name = key.partition(':')
        assert (JAX / rel).exists(), key
        if name:
            assert name in public_names(JAX / rel), key
    for key, name in RENAMED.items():
        assert name in bindings(PORT / key.partition(':')[0]), key
