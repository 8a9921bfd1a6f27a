"""Combinators: structured composition of generative functions.

Counterpart of ``genjax_tpu/combinators``: ``Scan`` (``scan.py``), ``Vmap``
(``vmap.py``), ``Switch`` (``switch.py``), ``Mask`` (``mask_comb.py``),
``Dimap`` (``dimap.py``), ``mix``, ``repeat``, ``or_else`` and the derived
decorators. Importing this package fills the constructor table behind the
postfix methods of ``GenerativeFunction`` (``gen_fn.vmap()``,
``.scan()``, ...).
"""

from ..generative.gfi import register_combinators
from .dimap import DimapCombinator, DimapTrace, contramap, dimap, map
from .mask_comb import MaskCombinator, MaskTrace, mask
from .mixture import mix
from .or_else import or_else
from .repeat import repeat
from .scan import (
    ScanCombinator,
    ScanTrace,
    accumulate,
    iterate,
    iterate_final,
    masked_iterate,
    masked_iterate_final,
    prepend_initial_acc,
    reduce,
    scan,
)
from .switch import SwitchCombinator, SwitchTrace, switch
from .vmap import VmapCombinator, VmapTrace, vmap

# the reference's class names
Scan = ScanCombinator
Vmap = VmapCombinator
Switch = SwitchCombinator
Dimap = DimapCombinator
RepeatCombinator = repeat

register_combinators(
    vmap=VmapCombinator,
    repeat=repeat,
    scan=scan,
    accumulate=accumulate,
    reduce=reduce,
    iterate=iterate,
    iterate_final=iterate_final,
    masked_iterate=masked_iterate,
    masked_iterate_final=masked_iterate_final,
    mask=MaskCombinator,
    or_else=or_else,
    switch=switch,
    mix=mix,
    dimap=dimap,
    map=map,
    contramap=contramap,
)

__all__ = [
    "Dimap",
    "RepeatCombinator",
    "Scan",
    "Switch",
    "Vmap",
    "DimapCombinator",
    "DimapTrace",
    "MaskCombinator",
    "MaskTrace",
    "ScanCombinator",
    "ScanTrace",
    "SwitchCombinator",
    "SwitchTrace",
    "VmapCombinator",
    "VmapTrace",
    "accumulate",
    "contramap",
    "dimap",
    "iterate",
    "iterate_final",
    "map",
    "mask",
    "masked_iterate",
    "masked_iterate_final",
    "mix",
    "or_else",
    "prepend_initial_acc",
    "reduce",
    "repeat",
    "scan",
    "switch",
    "vmap",
]
