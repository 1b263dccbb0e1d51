"""Input preprocessors — shape adapters between layer families, ported
from ``deeplearning4j_tpu/nn/conf/preprocessors.py``.

CNN → dense (a row-major flatten of NCHW, so the dense ``W`` rows line
up with the JAX package's), flat CNN → CNN, the recurrent adapters RNN →
dense and dense → RNN, which fold time into the batch and back, masks
with it, CNN → RNN and RNN → CNN (the batch folds ``timesteps`` images
per sequence), and ``ComposableInputPreProcessor``, a chain of others.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

PREPROC_REGISTRY: dict[str, type] = {}


def register_preproc(cls):
    PREPROC_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class InputPreProcessor:
    def __call__(self, x, mask=None):
        raise NotImplementedError

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        name = d.pop("@class")
        if name not in PREPROC_REGISTRY:
            raise NotImplementedError(
                f"preprocessor {name!r} is not ported to "
                f"deeplearning4j_tpu_torch yet (ported: "
                f"{sorted(PREPROC_REGISTRY)})")
        return PREPROC_REGISTRY[name](**d)


@register_preproc
@dataclasses.dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x, mask=None):
        return x.reshape(x.shape[0], -1), mask

    def output_type(self, input_type):
        return InputType.feed_forward(
            input_type.height * input_type.width * input_type.channels)


@register_preproc
@dataclasses.dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x, mask=None):
        if x.ndim == 4:
            return x, mask
        return x.reshape(x.shape[0], self.channels, self.height,
                         self.width), mask

    def output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preproc
@dataclasses.dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[N, T, C] -> [N*T, C], the mask [N, T] -> [N*T].  The time-step
    count goes on in the feed-forward InputType, so a later
    FeedForwardToRnn adapter can restore the sequence shape."""

    def __call__(self, x, mask=None):
        return x.reshape(-1, x.shape[-1]), (
            mask.reshape(-1) if mask is not None else None)

    def output_type(self, input_type):
        return InputType("ff", size=input_type.size,
                         timesteps=input_type.timesteps)


@register_preproc
@dataclasses.dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[N*T, C] -> [N, T, C], the mask [N*T] -> [N, T]."""

    timesteps: Optional[int] = None

    def __call__(self, x, mask=None):
        t = self.timesteps
        if t is None:
            raise ValueError(
                "FeedForwardToRnnPreProcessor needs static timesteps")
        return x.reshape(-1, t, x.shape[-1]), (
            mask.reshape(-1, t) if mask is not None else None)

    def output_type(self, input_type):
        return InputType.recurrent(input_type.flat_size(), self.timesteps)


@register_preproc
@dataclasses.dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """NCHW [N*T, C, H, W] -> [N, T, C*H*W]; the time-step count must be
    set (DL4J derives it from the runtime minibatch)."""

    timesteps: Optional[int] = None

    def __call__(self, x, mask=None):
        t = self.timesteps
        if t is None:
            raise ValueError(
                "CnnToRnnPreProcessor needs an explicit timestep count "
                "(DL4J derives it from the runtime minibatch; e.g. a "
                "migrated zip imports with timesteps=None) — set "
                "CnnToRnnPreProcessor(timesteps=T) on conf.preprocessors")
        flat = x.reshape(x.shape[0], -1)
        return flat.reshape(-1, t, flat.shape[-1]), mask

    def output_type(self, input_type):
        return InputType.recurrent(
            input_type.height * input_type.width * input_type.channels,
            self.timesteps)


@register_preproc
@dataclasses.dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """[N, T, C*H*W] -> NCHW [N*T, C, H, W]."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x, mask=None):
        return x.reshape(-1, self.channels, self.height, self.width), mask

    def output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preproc
@dataclasses.dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    """The preprocessors of ``parts`` (their serialized dicts) in order."""

    parts: list = dataclasses.field(default_factory=list)

    def __call__(self, x, mask=None):
        for d in self.parts:
            x, mask = InputPreProcessor.from_dict(d)(x, mask)
        return x, mask

    def output_type(self, input_type):
        for d in self.parts:
            input_type = InputPreProcessor.from_dict(d).output_type(
                input_type)
        return input_type

    @staticmethod
    def compose(*procs: InputPreProcessor) -> "ComposableInputPreProcessor":
        return ComposableInputPreProcessor(parts=[p.to_dict() for p in procs])
