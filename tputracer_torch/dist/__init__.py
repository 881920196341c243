"""Distribution on ``torch.distributed``, port of ``tputracer/dist``:
rays data-parallel (``mesh``), the geometry tiled round a ring
(``scene_shard``), ring-connection BDPT (``bdpt_ring``) and the world's
launch (``launch``).  Every entry point runs on every rank of the world."""

from tputracer_torch.dist.mesh import (  # noqa: F401
    fit_chain_bdpt_sharded,
    fit_chain_sharded,
    fit_step_bdpt_sharded,
    fit_step_opt_sharded,
    fit_step_sharded,
    make_mesh,
    render_bdpt_sharded,
    render_sharded,
)
from tputracer_torch.dist.scene_shard import (fit_chain_tiled,  # noqa: F401
                                              fit_step_tiled,
                                              render_bdpt_tiled,
                                              render_tiled)
from tputracer_torch.dist.bdpt_ring import render_bdpt_ring  # noqa: F401
