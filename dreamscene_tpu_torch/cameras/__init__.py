from dreamscene_tpu_torch.cameras.camera import (  # noqa: F401
    Camera,
    focal2fov,
    fov2focal,
    get_projection_matrix,
    get_world2view,
)
