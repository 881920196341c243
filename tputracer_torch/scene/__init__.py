from tputracer_torch.scene.types import (  # noqa: F401
    DIFFUSE,
    GLASS,
    MIRROR,
    Camera,
    Scene,
    make_camera,
    make_scene,
    scene_from_numpy,
)
from tputracer_torch.scene.cornell import cornell_box, furnace  # noqa: F401
