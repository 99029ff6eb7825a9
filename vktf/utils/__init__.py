from vktf.utils.data_view import as_view, size_bytes
from vktf.utils.delta_time import DeltaTime
from vktf.utils.timing import FrameTimer

__all__ = ["as_view", "size_bytes", "DeltaTime", "FrameTimer"]
