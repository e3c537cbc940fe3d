"""Make the port's examples runnable from a source checkout without pip
install.

Python puts the script's directory (examples/torch/) on sys.path, so each
example does ``import _bootstrap`` and this single copy inserts the repo
root ahead of it. With the package pip-installed the extra path entry is
harmless (the checkout's package simply wins when both exist).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def add_common(p, tiny_help=None):
    """``--device`` (the card unless ``cpu``) and ``--tiny`` (the test
    architecture, ``ArchConfig.micro()``; hidden unless ``tiny_help``)."""
    import argparse

    p.add_argument("--device", default="cuda",
                   help="cuda (the card, the default) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help=tiny_help or argparse.SUPPRESS)


def arch(args):
    """The architecture of ``--tiny``: ``ArchConfig.micro()``, else the
    full one."""
    from multimodal_auv_torch.models.model_utils import ArchConfig

    return ArchConfig.micro() if args.tiny else ArchConfig()
