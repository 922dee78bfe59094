"""Post-mortem debugger hook (the reference's root-level crash_on_ipy.py),
the port's own copy of ``vlp3d/utils/postmortem.py``: importing this
module, or calling :func:`install`, opens a post-mortem shell (IPython's
where it is installed, else pdb) on any uncaught exception of a process
whose standard error is a terminal.

Usage: ``import vlp3d_torch.utils.postmortem`` at the top of a script,
or ``python -c "import vlp3d_torch.utils.postmortem, runpy;
runpy.run_module('vlp3d_torch.cli.predict', run_name='__main__')"``.
"""

from __future__ import annotations

import sys


def install() -> None:
    def hook(exc_type, exc, tb):
        sys.__excepthook__(exc_type, exc, tb)
        if not sys.stderr.isatty():
            return
        try:
            from IPython.core import ultratb

            ultratb.FormattedTB(mode="Plain", call_pdb=1)(exc_type, exc, tb)
        except ImportError:
            import pdb

            pdb.post_mortem(tb)

    sys.excepthook = hook


install()
