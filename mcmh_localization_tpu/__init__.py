"""Alias of the ``mcmh_localization`` package under the package's former
name, so existing imports keep working; new code imports
``mcmh_localization``."""

import sys

import mcmh_localization as _package

sys.modules[__name__] = _package
