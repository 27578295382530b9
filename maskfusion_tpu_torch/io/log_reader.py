"""Abstract frame source (ref: GUI/Tools/LogReader.h:31-85).

Copy of ``maskfusion_tpu/io/log_reader.py`` for the PyTorch port."""

from __future__ import annotations

import abc
from typing import Optional

from maskfusion_tpu_torch.frame import FrameData


class LogReader(abc.ABC):
    def __init__(self, file: str, flip_colors: bool = False):
        self.file = file
        self.flip_colors = flip_colors
        self.current_frame = 0

    @abc.abstractmethod
    def get_next(self) -> Optional[FrameData]:
        ...

    @abc.abstractmethod
    def has_more(self) -> bool:
        ...

    def get_num_frames(self) -> int:
        return -1

    def fast_forward(self, frame: int):
        while self.current_frame < frame and self.has_more():
            self.get_next()

    def rewind(self) -> bool:
        return False

    def has_masks(self) -> bool:
        return False

    def __iter__(self):
        while self.has_more():
            f = self.get_next()
            if f is None:
                break
            yield f
