from vktf.scene.flatten import RenderScene, SceneMeta, flatten_assets

__all__ = ["RenderScene", "SceneMeta", "flatten_assets", "Scene"]


def __getattr__(name):
    if name == "Scene":
        from vktf.scene.scene import Scene

        return Scene
    raise AttributeError(f"module 'vktf.scene' has no attribute {name!r}")
