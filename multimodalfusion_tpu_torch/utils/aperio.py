"""openslide's rules for Aperio ``.svs`` slides (its Aperio vendor
code), on the port's TIFF reader (``utils/tiff.py``), in numpy and the
standard library: which pages are the pyramid's levels, which are associated
images, each level's downsample and the slide's properties.
``data/wsi.py``'s ``OpenSlideBackend`` reads the levels' tiles.

- A file is Aperio when its first page is tiled and its
  ``ImageDescription`` starts with ``Aperio`` (``is_aperio``).
- The levels are the tiled pages, in file order; a tiled page after the
  first must be reduced-resolution (NewSubfileType bit 0), else the file
  is refused, as openslide refuses it.
- The stripped pages are associated images: page 1 is ``thumbnail``;
  another is named by the first word of its description's second line
  (``label``, ``macro``), lines split at every CR and LF as openslide
  splits them, and is left out when that line is empty.
- Each level's downsample is ``(w0 / w + h0 / h) / 2``.
- The properties (``properties``) are openslide's strings:
  ``aperio.<key>`` for each ``key = value`` field after the first ``|``
  of level 0's description (keys and values stripped of ASCII
  whitespace; a field without ``=`` is left out); ``openslide.mpp-x``
  and ``openslide.mpp-y`` from ``aperio.MPP`` parsed as a decimal number
  (a comma read as the decimal point) and written back with ``%.17g``,
  as glib's ``g_ascii_dtostr`` writes it; ``openslide.objective-power``
  from ``aperio.AppMag`` when it is a whole number; ``openslide.vendor``
  = ``aperio``.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from multimodalfusion_tpu_torch.utils import tiff

PREFIX = "Aperio"
_WHITESPACE = " \t\n\v\f\r"  # what glib's g_strstrip strips
_DECIMAL = re.compile(r"[ \t\n\v\f\r]*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")
_INTEGER = re.compile(r"[ \t\n\v\f\r]*[+-]?\d+")


class Aperio(NamedTuple):
    levels: List[int]              # page index of each level, level 0 first
    dimensions: List[Tuple[int, int]]  # (width, height) of each level
    downsamples: List[float]
    associated: Dict[str, int]     # associated image name -> page index
    properties: Dict[str, str]


def is_aperio(pages: Sequence[tiff.Page]) -> bool:
    """Whether openslide's Aperio vendor code takes the file of ``pages``."""
    first = pages[0]
    return bool(first.tile) and (first.description or "").startswith(PREFIX)


def downsamples(dims: Sequence[Tuple[int, int]]) -> List[float]:
    """openslide's downsample of each level (w, h) against the first."""
    w0, h0 = dims[0]
    return [(w0 / w + h0 / h) / 2 for w, h in dims]


def properties(description: str) -> Dict[str, str]:
    """openslide's properties of an Aperio slide whose level 0 has the
    ImageDescription ``description`` (see the module)."""
    props = {"openslide.vendor": "aperio"}
    for field in description.split("|")[1:]:
        key, eq, value = field.partition("=")
        if eq:
            props[f"aperio.{key.strip(_WHITESPACE)}"] = value.strip(
                _WHITESPACE)
    mpp = props.get("aperio.MPP", "").replace(",", ".")
    if _DECIMAL.fullmatch(mpp) and float(mpp) != float("inf"):
        props["openslide.mpp-x"] = props["openslide.mpp-y"] = (
            "%.17g" % float(mpp))
    mag = props.get("aperio.AppMag", "")
    if _INTEGER.fullmatch(mag):
        props["openslide.objective-power"] = str(int(mag))
    return props


def _associated_name(index: int, page: tiff.Page) -> Optional[str]:
    if index == 1:
        return "thumbnail"
    lines = re.split("[\r\n]", page.description or "")
    if len(lines) < 2 or not lines[1]:
        return None
    return lines[1].split(" ")[0]


def read_aperio(path: str, pages: Sequence[tiff.Page]) -> Aperio:
    """The levels, associated images and properties of the Aperio slide
    (``is_aperio``) at ``path`` whose pages (``tiff.read_pages``) are
    ``pages``."""
    levels, associated = [], {}
    for i, page in enumerate(pages):
        if page.tile:
            if i and not page.subfile_type & 1:
                raise ValueError(f"{path}: page {i} is tiled but not "
                                 f"reduced-resolution (NewSubfileType "
                                 f"{page.subfile_type}); openslide refuses "
                                 f"the slide")
            levels.append(i)
        else:
            name = _associated_name(i, page)
            if name is not None:
                associated[name] = i
    dims = [(pages[i].width, pages[i].height) for i in levels]
    return Aperio(levels, dims, downsamples(dims), associated,
                  properties(pages[0].description))
