from tputracer_torch.scene.types import (  # noqa: F401
    DIFFUSE,
    GLASS,
    MIRROR,
    Camera,
    Scene,
    kernel_route,
    make_camera,
    make_scene,
    scene_from_numpy,
    wants_grad,
)
from tputracer_torch.scene.cornell import cornell_box, furnace  # noqa: F401
from tputracer_torch.scene.mesh import (  # noqa: F401
    load_mtl,
    load_obj,
    load_obj_with_materials,
    mesh_scene,
    obj_scene,
)
