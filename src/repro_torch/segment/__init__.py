"""repro_torch.segment: non-uniform (hierarchical power-of-two)
segmentation, the twin of ``repro.segment``.

The uniform paper layout is the degenerate case of a dyadic prefix tree;
this package generates, decides, costs and packs the general case:

  * :class:`Segmentation`: the combinatorial tree (tree.py)
  * :func:`decide_segmentation`: §III decisions per depth group (decide.py)
  * :func:`explore_segmented`: the greedy split refinement (segmenter.py)
  * :class:`SegmentedDesign`: the verified artifact + int64 oracle
    (design.py)
  * :func:`estimate_segmented`: target costs incl. decoder (cost.py)
"""
from repro_torch.segment.cost import estimate_segmented
from repro_torch.segment.decide import decide_segmentation
from repro_torch.segment.design import SegmentedDesign
from repro_torch.segment.segmenter import explore_segmented, min_uniform_depth
from repro_torch.segment.tree import Segmentation

__all__ = [
    "Segmentation",
    "SegmentedDesign",
    "decide_segmentation",
    "explore_segmented",
    "min_uniform_depth",
    "estimate_segmented",
]
