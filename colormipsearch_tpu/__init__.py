"""Color depth MIP search engine on an accelerator (JAX).

Library surface (the CLI in `cli/` wraps these):

    from colormipsearch_tpu import CDSParams, color_depth_search

    matches = color_depth_search(mask_neurons, target_neurons,
                                 CDSParams(mask_threshold=20, ...))

See PARITY.md for the mapping to the reference implementation and
docs/DESIGN.md for the architecture.
"""

__version__ = "0.2.0"

from colormipsearch_tpu.engine.cds import CDSParams


def color_depth_search(masks, targets, params=None, *, neg_query=None,
                       neg_query_threshold=None, mirror_neg_query=False,
                       **kwargs):
    """All-pairs pixel-match search; returns CDMatch entities.

    Args:
      masks/targets: Neuron entities (see model/) or image file paths.
      params: CDSParams (defaults to production-like values).
      neg_query: optional negative-query image (path or uint8 RGB array)
        whose matches are subtracted from every mask's score
        (PixelMatchColorDepthSearchAlgorithm.java:195-217).
      neg_query_threshold / mirror_neg_query: negative-query variant of
        the mask threshold / mirror flags.
      kwargs: forwarded to CDSearchEngine.find_all_matches.
    """
    from colormipsearch_tpu.engine.cds import CDSearchEngine
    from colormipsearch_tpu.io import mips as mips_io
    from colormipsearch_tpu.model import Neuron

    def to_neurons(items):
        paths = [i for i in items if not isinstance(i, Neuron)]
        out = [i for i in items if isinstance(i, Neuron)]
        if paths:
            fds = []
            for p in paths:
                fds.extend(mips_io.list_image_files(str(p)))
            out.extend(mips_io.neurons_from_image_files(fds))
        return out

    neg_rgb = None
    if neg_query is not None:
        import numpy as _np
        if isinstance(neg_query, _np.ndarray):
            neg_rgb = neg_query
        else:
            from colormipsearch_tpu.io.image import read_image
            neg_rgb = read_image(str(neg_query)).as_rgb()

    engine = CDSearchEngine(params or CDSParams(), neg_query_rgb=neg_rgb,
                            neg_query_threshold=neg_query_threshold,
                            mirror_neg_query=mirror_neg_query)
    return engine.find_all_matches(to_neurons(masks), to_neurons(targets),
                                   **kwargs)


def gradient_scores(matches, params=None, **kwargs):
    """Shape (gradient-area-gap) rescoring of existing matches."""
    from colormipsearch_tpu.engine.gradscore import GradScoreEngine

    engine = GradScoreEngine(params or CDSParams())
    return engine.score_matches(matches, **kwargs)


__all__ = ["CDSParams", "color_depth_search", "gradient_scores",
           "__version__"]
