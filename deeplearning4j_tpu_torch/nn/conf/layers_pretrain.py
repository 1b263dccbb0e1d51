"""Unsupervised / pretrain layers, the centre-loss head and the 1D conv
family — the port of ``deeplearning4j_tpu/nn/conf/layers_pretrain.py``.

(ref: VariationalAutoencoder.java, AutoEncoder.java, RBM.java,
CenterLossOutputLayer.java, Convolution1DLayer.java,
Subsampling1DLayer.java.)  Fields, JSON and param names are the JAX
package's, so a zip either package writes restores in the other.

A pretrain layer's loss comes in two parts: ``draw_noise(x, generator)``
draws the step's randomness from a ``torch.Generator`` on ``x``'s device
(the autoencoder's keep mask, the RBM's Gibbs uniforms or normals, the
VAE's ε), and ``pretrain_loss(params, x, noise)`` is a pure function of
the params, the input and that noise, which autograd differentiates.
Given the noise the JAX package drew from its key, the loss is the JAX
loss.  The RBM's CD-k update is autograd of the free-energy surrogate
``E(v_d, sg(h_d)) - E(sg(v_m), sg(h_m))``, ``sg`` being ``.detach()``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseOutputLayer, Layer, register_layer)
from deeplearning4j_tpu_torch.ops import activations as act_ops
from deeplearning4j_tpu_torch.ops import convolution as conv_ops
from deeplearning4j_tpu_torch.ops import losses as loss_ops
from deeplearning4j_tpu_torch.ops import vae_distributions as vae_dist


def _uniform(shape, like, generator):
    return torch.rand(shape, dtype=like.dtype, device=like.device,
                      generator=generator)


def _normal(shape, like, generator):
    return torch.randn(shape, dtype=like.dtype, device=like.device,
                       generator=generator)


def _dense_pretrain_params(layer, generator, input_type, device):
    n_in = layer.n_in or input_type.flat_size()
    return {"W": layer._winit(generator, (n_in, layer.n_out), device),
            "b": layer._binit((layer.n_out,), device),
            "vb": torch.zeros((n_in,), dtype=torch.float32, device=device)}


@register_layer
@dataclasses.dataclass
class AutoEncoder(Layer):
    """Denoising autoencoder with tied decode weights (W^T)
    (ref: AutoEncoder.java — ``decode`` uses W.transpose, corruption via
    ``getCorruptedInput``)."""

    n_in: Optional[int] = None
    n_out: int = 0
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: str = "mse"

    def is_pretrain_layer(self):
        return True

    def initialize(self, generator, input_type, device):
        return (_dense_pretrain_params(self, generator, input_type, device),
                InputType.feed_forward(self.n_out))

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        x = self._maybe_dropout(x, train, seed)
        return self.encode(params, x), state, mask

    def encode(self, params, x):
        return self._act(x @ params["W"] + params["b"])

    def decode(self, params, h):
        return self._act(h @ params["W"].T + params["vb"])

    def draw_noise(self, x, generator=None) -> dict:
        """The masking corruption's keep mask: each input kept with
        probability 1 - corruption_level (none when that is 0)."""
        if self.corruption_level <= 0.0:
            return {}
        keep = _uniform(x.shape, x, generator) < 1.0 - self.corruption_level
        return {"keep": keep.to(x.dtype)}

    def pretrain_loss(self, params, x, noise):
        """Mean reconstruction loss on the corrupted input."""
        x_in = x * noise["keep"] if "keep" in noise else x
        h = self.encode(params, x_in)
        pre_recon = h @ params["W"].T + params["vb"]
        per_ex = loss_ops.get(self.loss)(x, pre_recon,
                                         self.activation or "sigmoid", None)
        loss = per_ex.mean()
        if self.sparsity > 0.0:
            rho_hat = torch.clamp(h.mean(dim=0), 1e-7, 1.0 - 1e-7)
            rho = self.sparsity
            kl = rho * torch.log(rho / rho_hat) + \
                (1 - rho) * torch.log((1 - rho) / (1 - rho_hat))
            loss = loss + kl.sum()
        return loss

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)


@register_layer
@dataclasses.dataclass
class RBM(Layer):
    """Restricted Boltzmann machine trained by CD-k (ref: RBM.java
    ``contrastiveDivergence``; unit kinds from nn/conf/layers/RBM.java).
    The CD-k gradient is autograd of the free-energy surrogate with the
    Gibbs chain's end detached."""

    n_in: Optional[int] = None
    n_out: int = 0
    hidden_unit: str = "binary"    # binary | gaussian | relu
    visible_unit: str = "binary"   # binary | gaussian | linear
    k: int = 1
    sparsity: float = 0.0

    def is_pretrain_layer(self):
        return True

    def initialize(self, generator, input_type, device):
        return (_dense_pretrain_params(self, generator, input_type, device),
                InputType.feed_forward(self.n_out))

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        """Supervised use: the hidden means (ref: RBM.activate)."""
        x = self._maybe_dropout(x, train, seed)
        return self._hidden_mean(params, x), state, mask

    def _hidden_mean(self, params, v):
        pre = v @ params["W"] + params["b"]
        if self.hidden_unit == "relu":
            return torch.relu(pre)
        if self.hidden_unit == "gaussian":
            return pre
        return torch.sigmoid(pre)

    def _visible_mean(self, params, h):
        pre = h @ params["W"].T + params["vb"]
        if self.visible_unit in ("gaussian", "linear"):
            return pre
        return torch.sigmoid(pre)

    @staticmethod
    def _sample(mean, unit, noise):
        """A unit's sample from its mean and the drawn noise: Bernoulli
        from uniforms, Gaussian from normals, else the mean (mean-field)."""
        if unit == "binary":
            return (noise < mean).to(mean.dtype)
        if unit == "gaussian":
            return mean + noise
        return mean

    def _noise_for(self, unit, shape, like, generator):
        if unit == "binary":
            return _uniform(shape, like, generator)
        if unit == "gaussian":
            return _normal(shape, like, generator)
        return None

    def draw_noise(self, x, generator=None) -> dict:
        """Per Gibbs step, the hidden then the visible sample's noise:
        uniforms for binary units, standard normals for Gaussian ones,
        none for relu / linear units (mean-field)."""
        n = x.shape[0]
        hs, vs = [], []
        for _ in range(self.k):
            hs.append(self._noise_for(self.hidden_unit, (n, self.n_out), x,
                                      generator))
            vs.append(self._noise_for(self.visible_unit, tuple(x.shape), x,
                                      generator))
        return {"h": hs, "v": vs}

    def gibbs_chain(self, params, x, noise):
        """The end of the k-step Gibbs chain v → h → v from ``x``."""
        v = x
        for nh, nv in zip(noise["h"], noise["v"]):
            h = self._sample(self._hidden_mean(params, v), self.hidden_unit,
                             nh)
            v = self._sample(self._visible_mean(params, h),
                             self.visible_unit, nv)
        return v

    def free_energy(self, params, v):
        """Free energy with the hidden units marginalized: binary (and
        relu) hidden -Σ softplus(pre), Gaussian hidden -½Σ pre²; a Gaussian
        visible layer adds ||v||²/2."""
        pre_h = v @ params["W"] + params["b"]
        if self.hidden_unit == "gaussian":
            marg = 0.5 * torch.sum(pre_h * pre_h, dim=-1)
        else:
            marg = torch.sum(torch.nn.functional.softplus(pre_h), dim=-1)
        fe = -(v @ params["vb"]) - marg
        if self.visible_unit in ("gaussian", "linear"):
            fe = fe + 0.5 * torch.sum(v * v, dim=-1)
        return fe

    def _energy(self, params, v, h):
        """Joint energy E(v, h) = -v·vb - h·hb - vᵀWh (+½||v||² for a
        Gaussian visible layer)."""
        e = -(v @ params["vb"]) - (h @ params["b"]) - \
            torch.sum((v @ params["W"]) * h, dim=-1)
        if self.visible_unit in ("gaussian", "linear"):
            e = e + 0.5 * torch.sum(v * v, dim=-1)
        return e

    def pretrain_loss(self, params, x, noise):
        """CD-k surrogate E(v_d, sg(h_d)) - E(sg(v_m), sg(h_m)) with mean
        hidden activations: its gradient is the classic CD update
        (dW = v_dᵀh_d - v_mᵀh_m)."""
        v_model = self.gibbs_chain(params, x, noise).detach()
        h_data = self._hidden_mean(params, x).detach()
        h_model = self._hidden_mean(params, v_model).detach()
        loss = torch.mean(self._energy(params, x, h_data) -
                          self._energy(params, v_model, h_model))
        if self.sparsity > 0.0:
            rho_hat = torch.clamp(torch.mean(self._hidden_mean(params, x)),
                                  1e-7, 1.0 - 1e-7)
            loss = loss + (self.sparsity - rho_hat) ** 2
        return loss

    def reconstruction_error(self, params, x) -> float:
        """Monitoring metric: the one-step reconstruction MSE."""
        with torch.no_grad():
            v = self._visible_mean(params, self._hidden_mean(params, x))
            return float(torch.mean((x - v) ** 2))

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)


@register_layer
@dataclasses.dataclass
class VariationalAutoencoder(Layer):
    """VAE (Kingma & Welling) with MLP encoder and decoder stacks
    (ref: VariationalAutoencoder.java — encoderLayerSizes,
    decoderLayerSizes, pzxActivationFn, reconstructionDistribution,
    numSamples).  In a supervised net ``forward`` emits the mean of q(z|x)
    through ``pzx_activation``; ``pretrain_loss`` is the negative ELBO by
    the reparameterization trick, averaged over ``num_samples`` draws of
    ε."""

    n_in: Optional[int] = None
    n_out: int = 0                     # latent size
    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    pzx_activation: str = "identity"
    reconstruction_distribution: Optional[dict] = None
    num_samples: int = 1

    def is_pretrain_layer(self):
        return True

    def _dist(self):
        return vae_dist.make(self.reconstruction_distribution)

    def initialize(self, generator, input_type, device):
        n_in = self.n_in or input_type.flat_size()

        def zeros(n):
            return torch.zeros((n,), dtype=torch.float32, device=device)
        params = {}
        prev = n_in
        for i, sz in enumerate(self.encoder_layer_sizes):
            params[f"eW{i}"] = self._winit(generator, (prev, sz), device)
            params[f"eb{i}"] = zeros(sz)
            prev = sz
        params["pZXMeanW"] = self._winit(generator, (prev, self.n_out),
                                         device)
        params["pZXMeanb"] = zeros(self.n_out)
        params["pZXLogStd2W"] = self._winit(generator, (prev, self.n_out),
                                            device)
        params["pZXLogStd2b"] = zeros(self.n_out)
        prev = self.n_out
        for i, sz in enumerate(self.decoder_layer_sizes):
            params[f"dW{i}"] = self._winit(generator, (prev, sz), device)
            params[f"db{i}"] = zeros(sz)
            prev = sz
        n_dist = self._dist().n_dist_params(n_in)
        params["pXZW"] = self._winit(generator, (prev, n_dist), device)
        params["pXZb"] = zeros(n_dist)
        return params, InputType.feed_forward(self.n_out)

    def encode_mean_logvar(self, params, x):
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = self._act(h @ params[f"eW{i}"] + params[f"eb{i}"])
        mean = h @ params["pZXMeanW"] + params["pZXMeanb"]
        logvar = h @ params["pZXLogStd2W"] + params["pZXLogStd2b"]
        return mean, logvar

    def decode(self, params, z):
        """The decoder stack to the distribution's pre-output."""
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = self._act(h @ params[f"dW{i}"] + params[f"db{i}"])
        return h @ params["pXZW"] + params["pXZb"]

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        x = self._maybe_dropout(x, train, seed)
        mean, _ = self.encode_mean_logvar(params, x)
        return act_ops.get(self.pzx_activation)(mean), state, mask

    def draw_noise(self, x, generator=None, num_samples=None) -> dict:
        """ε ~ N(0, I), [num_samples, N, latent]."""
        ns = num_samples or max(self.num_samples, 1)
        return {"eps": _normal((ns, x.shape[0], self.n_out), x, generator)}

    def pretrain_loss(self, params, x, noise):
        """Negative ELBO = E_q[-log p(x|z)] + KL(q(z|x) || N(0, I))."""
        dist = self._dist()
        mean, logvar = self.encode_mean_logvar(params, x)
        mean_a = act_ops.get(self.pzx_activation)(mean)
        kl = 0.5 * torch.sum(mean_a ** 2 + torch.exp(logvar) - 1.0 - logvar,
                             dim=-1)
        recon = 0.0
        for s in range(self.num_samples):
            z = mean_a + torch.exp(0.5 * logvar) * noise["eps"][s]
            recon = recon + dist.neg_log_prob(x, self.decode(params, z))
        recon = recon / self.num_samples
        return torch.mean(recon + kl)

    # ---- the reference's inference surface ----
    def reconstruction_log_probability(self, params, x, generator=None,
                                       num_samples=None, noise=None):
        """Per-example Monte Carlo estimate of log p(x) over
        ``num_samples`` draws of ε (``noise`` when given, else drawn from
        ``generator``) (ref: reconstructionLogProbability)."""
        if noise is None:
            noise = self.draw_noise(x, generator, num_samples)
        eps_all = noise["eps"]
        dist = self._dist()
        mean, logvar = self.encode_mean_logvar(params, x)
        mean_a = act_ops.get(self.pzx_activation)(mean)
        std = torch.exp(0.5 * logvar)
        log2pi = math.log(2 * math.pi)
        lps = []
        for eps in eps_all:
            z = mean_a + std * eps
            log_pxz = -dist.neg_log_prob(x, self.decode(params, z))
            log_pz = -0.5 * torch.sum(z ** 2 + log2pi, dim=-1)
            log_qzx = -0.5 * torch.sum(eps ** 2 + log2pi + logvar, dim=-1)
            lps.append(log_pxz + log_pz - log_qzx)
        return (torch.logsumexp(torch.stack(lps), dim=0)
                - math.log(float(len(lps))))

    def generate_at_mean_given_z(self, params, z):
        """(ref: generateAtMeanGivenZ)"""
        z = torch.as_tensor(z, dtype=params["pXZW"].dtype,
                            device=params["pXZW"].device)
        return self._dist().mean(self.decode(params, z))

    def generate_random_given_z(self, params, z, generator=None):
        z = torch.as_tensor(z, dtype=params["pXZW"].dtype,
                            device=params["pXZW"].device)
        return self._dist().sample(self.decode(params, z), generator)

    def reconstruction_error(self, params, x):
        """(ref: reconstructionError — deterministic, the mean path)"""
        mean, _ = self.encode_mean_logvar(params, x)
        mean_a = act_ops.get(self.pzx_activation)(mean)
        recon = self._dist().mean(self.decode(params, mean_a))
        return torch.sum((x - recon) ** 2, dim=-1)

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)


@register_layer
@dataclasses.dataclass
class CenterLossOutputLayer(BaseOutputLayer):
    """Softmax + centre-loss head (ref: CenterLossOutputLayer.java: the
    score adds lambda/2 · ||f - c_y||²; centres ``cL`` move toward the
    class feature means at rate alpha).  The features are the output
    layer's input, which the engine hands over
    (``requires_features_for_score``).  ``.detach()`` and a zero-valued
    centre term give autograd the reference's asymmetric updates: features
    pulled at rate lambda, centres moved at rate alpha.
    ``gradient_check=True`` is the plain quadratic (the reference's
    Builder.gradientCheck flag)."""

    alpha: float = 0.05
    lambda_: float = 2e-4
    gradient_check: bool = False

    requires_features_for_score = True

    def initialize(self, generator, input_type, device):
        n_in = self.n_in or input_type.flat_size()
        params = {"W": self._winit(generator, (n_in, self.n_out), device),
                  "b": self._binit((self.n_out,), device),
                  "cL": torch.zeros((self.n_out, n_in), dtype=torch.float32,
                                    device=device)}
        return params, InputType.feed_forward(self.n_out)

    def compute_score(self, labels, preout, mask=None):
        raise NotImplementedError(
            "CenterLossOutputLayer needs the pre-output features for its "
            "score; it is supported in MultiLayerNetwork (which routes "
            "through compute_score_with_features) but not yet as a "
            "ComputationGraph output layer.")

    def compute_score_with_features(self, labels, preout, features, params,
                                    mask=None):
        base = loss_ops.get(self.loss)(labels, preout,
                                       self.activation or "softmax", mask)
        centers = labels @ params["cL"]    # one-hot [N, C] @ [C, F]
        if self.gradient_check:
            intra = 0.5 * self.lambda_ * torch.sum(
                (features - centers) ** 2, dim=-1)
        else:
            # value (lambda/2)||f - c||², d/df = lambda (f - c)
            pull = 0.5 * self.lambda_ * torch.sum(
                (features - centers.detach()) ** 2, dim=-1)
            # value 0, d/dc = alpha (c - f): the reference's centre update
            sq = torch.sum((features.detach() - centers) ** 2, dim=-1)
            move = 0.5 * self.alpha * (sq - sq.detach())
            intra = pull + move
        if mask is not None and mask.ndim == base.ndim:
            intra = intra * mask
        return base + intra


# ==========================================================================
# 1D convolution family (sequences [N, T, C])
# ==========================================================================

@register_layer
@dataclasses.dataclass
class Convolution1DLayer(Layer):
    """1D conv over RNN-format sequences (ref: Convolution1DLayer.java),
    weights [K, C_in, C_out].  Masked steps are zeroed on the way in; the
    mask passes through where the length is kept (stride 1, 'same')."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    convolution_mode: str = "same"

    def initialize(self, generator, input_type, device):
        c_in = self.n_in or input_type.size
        params = {"W": self._winit(generator, (self.kernel, c_in, self.n_out),
                                   device, fan_in=c_in * self.kernel,
                                   fan_out=self.n_out * self.kernel),
                  "b": self._binit((self.n_out,), device)}
        return params, self.output_type(input_type)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        x = self._maybe_dropout(x, train, seed)
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        y = conv_ops.conv1d(x, params["W"], params["b"], self.stride,
                            self.padding, self.dilation,
                            self.convolution_mode)
        keep = (mask is not None and self.stride == 1
                and self.convolution_mode == "same")
        return self._act(y), state, mask if keep else None

    def output_type(self, input_type):
        t = input_type.timesteps
        if t is not None:
            t = conv_ops.conv1d_output_len(t, self.kernel, self.stride,
                                           self.padding, self.dilation,
                                           self.convolution_mode)
        return InputType.recurrent(self.n_out, t)


@register_layer
@dataclasses.dataclass
class Subsampling1DLayer(Layer):
    """1D pooling over sequences (ref: Subsampling1DLayer.java).  With a
    mask, padded steps do not contribute (MaskedReductionUtil): max fills
    them with the dtype's lowest value, avg divides by the live count; the
    output mask is the max-pool of the input mask and masked windows give
    0."""

    pooling_type: str = "max"
    kernel: int = 2
    stride: int = 2
    padding: int = 0
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def has_params(self):
        return False

    def initialize(self, generator, input_type, device):
        return {}, self.output_type(input_type)

    def _pool(self, x, kind, pnorm=2):
        return conv_ops.pool1d(x, kind, self.kernel, self.stride,
                               self.padding, self.convolution_mode, pnorm)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        kind = self.pooling_type.lower()
        if mask is None:
            return self._pool(x, kind, self.pnorm), state, None
        mf = mask[..., None].to(x.dtype)
        if kind == "max":
            y = self._pool(torch.where(mf > 0, x, torch.finfo(x.dtype).min),
                           "max")
        elif kind in ("avg", "mean"):
            cnt = self._pool(mf.expand(x.shape), "sum")
            y = self._pool(x * mf, "sum") / torch.clamp_min(cnt, 1.0)
        elif kind == "sum":
            y = self._pool(x * mf, "sum")
        else:
            y = self._pool(x * mf, "pnorm", self.pnorm)
        out_mask = self._pool(mf, "max")[..., 0]
        y = y * (out_mask[..., None] > 0).to(x.dtype)
        return y, state, out_mask

    def output_type(self, input_type):
        t = input_type.timesteps
        if t is not None:
            t = conv_ops.conv1d_output_len(t, self.kernel, self.stride,
                                           self.padding, 1,
                                           self.convolution_mode)
        return InputType.recurrent(input_type.size, t)
