"""The port's API page, ``docs/torch_api.md``, names every public name of
every public module of the port, as ``tools/cbdocs.py``'s coverage gate
does for the JAX package: a name counts when it appears in a code span
or a fenced block, in any of its camelCase or snake_case spellings."""

import importlib
import re
from pathlib import Path

import pytest

pytest.importorskip('torch')

import cueball_tpu_torch  # noqa: E402
from tools.cbdocs import _normalize, _public_names  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PAGE = ROOT / 'docs' / 'torch_api.md'


def _documented() -> set:
    text = PAGE.read_text(encoding='utf-8')
    chunks = re.findall(r'^```.*?^```', text, flags=re.M | re.S)
    prose = re.sub(r'^```.*?^```', '', text, flags=re.M | re.S)
    chunks += re.findall(r'`([^`]+)`', prose)
    return {_normalize(w) for chunk in chunks
            for w in re.findall(r'[A-Za-z_][A-Za-z0-9_]*', chunk)}


def test_api_modules_are_the_package_modules():
    """The list holds every source file of the package but the private
    ones (a path part starting with ``_``, ``__init__.py`` aside), read
    from the disk rather than through the import system, so a directory
    the walk cannot enter (one without ``__init__.py``) shows."""
    pkg = Path(cueball_tpu_torch.__file__).resolve().parent
    on_disk = []
    for f in pkg.rglob('*.py'):
        parts = f.relative_to(pkg.parent).with_suffix('').parts
        if parts[-1] == '__init__':
            parts = parts[:-1]
        if not any(part.startswith('_') for part in parts):
            on_disk.append('.'.join(parts))
    listed = cueball_tpu_torch.api_modules()
    assert sorted(listed) == sorted(on_disk)
    assert len(set(listed)) == len(listed)


@pytest.mark.parametrize('modname', cueball_tpu_torch.api_modules())
def test_api_page_names_every_public_name(modname):
    words = _documented()
    mod = importlib.import_module(modname)
    missing = [n for n in _public_names(mod) if _normalize(n) not in words]
    assert missing == [], '%s: not on %s' % (modname, PAGE.name)
    # The page names the module itself, too.
    assert _normalize(modname.rpartition('.')[2]) in words
