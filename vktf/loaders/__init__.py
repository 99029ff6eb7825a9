from vktf.loaders.gltf import Asset, load_gltf

__all__ = ["Asset", "load_gltf", "load_ktx"]


def __getattr__(name):
    if name == "load_ktx":
        from vktf.loaders.ktx import load_ktx

        return load_ktx
    raise AttributeError(f"module 'vktf.loaders' has no attribute {name!r}")
