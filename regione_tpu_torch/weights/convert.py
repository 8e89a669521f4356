"""diffusers checkpoints -> the port's modules.

Counterpart of `regione_tpu/weights/convert.py`.  The port's `nn.Linear` and
`nn.Conv2d` keep torch's layouts, so a diffusers tensor mostly changes its
name; the layout changes are:
  * the single block's `linear1` is [to_q ‖ to_k ‖ to_v ‖ proj_mlp] along
    the output rows;
  * the final AdaLayerNormContinuous emits [scale, shift], the port's
    `final_mod` [shift, scale]: its two row halves are swapped;
  * the Step1X connector's fused `self_attn_qkv` is split by rows;
  * a Wan causal 3-D conv keeps its last time tap (`_fold_causal3d`), a 1x1
    conv that is a linear drops its spatial axes.
Tensors are streamed one at a time from the memory-mapped shards
(`weights.checkpoint.SafetensorsFile`, any of BF16 / F16 / F32): each is
cast to its parameter's dtype and moved to the device as it is converted,
so no fp32 copy of the model is built on the host.  `load_converted(...,
mesh=)` loads a tensor-parallel rank's shards straight from the mapped
files: each tensor is cut to the rank's slices (`parallel.sharding.
shard_tensor`; the fused linear1 and final_mod's swapped halves are kept
as their parts, `RowCat`, so only the rank's rows are read) before it is
cast and moved, and no whole tensor reaches the card.  Every source tensor
must be consumed (`TrackingState`): a leftover means a wrong mapping or a
checkpoint of another architecture.

Offline:  python -m regione_tpu_torch.weights.convert --model_path <dir> \\
              --backend step1x-edit --out <dir> [--device cpu]
writes <out>/transformer.safetensors and <out>/vae.safetensors
(`weights.checkpoint.save`; `checkpoint.mmdit_from_checkpoint` reads the
first back).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import torch

from regione_tpu_torch.parallel.sharding import RowCat, load_shards
from regione_tpu_torch.weights.checkpoint import SafetensorsFile


class TrackingState(dict):
    """A state dict recording which source tensors were read, so a
    conversion can require that none is left over."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.consumed: set[str] = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return super().__getitem__(k)

    def unconsumed(self, ignore_patterns: tuple[str, ...] = ()) -> list[str]:
        left = [k for k in self.keys() if k not in self.consumed]
        return [k for k in left
                if not any(re.search(p, k) for p in ignore_patterns)]


def _load_torch_state(model_dir) -> dict:
    """{name: CPU tensor} of every *.safetensors shard under `model_dir`
    (views of the mapped files, no copy), or of its torch *.bin files."""
    model_dir = Path(model_dir)
    shards = sorted(model_dir.glob("*.safetensors"))
    if shards:
        state = {}
        for path in shards:
            f = SafetensorsFile(path)
            state.update((k, f.get(k)) for k in f.keys())
        return state
    bins = sorted(model_dir.glob("*.bin"))
    if bins:
        state = {}
        for path in bins:
            state.update(torch.load(str(path), map_location="cpu",
                                    weights_only=True, mmap=True))
        return state
    raise FileNotFoundError(f"no safetensors/bin files in {model_dir}")


class _Converter:
    """Reads source tensors by name and writes the port's {name: tensor}
    on `device` in `dtype`.  `shard`: None, or (port name, whole tensor or
    `RowCat`) -> this rank's part; source tensors then stay the mapped
    file's views until `put` cuts them."""

    def __init__(self, state, device, dtype, shard=None):
        self.state = state if isinstance(state, TrackingState) \
            else TrackingState(state)
        self.device, self.dtype, self.shard = device, dtype, shard
        self.out: dict[str, torch.Tensor] = {}

    def get(self, key):
        t = self.state[key]
        if self.shard is not None:
            return t
        return t.to(device=self.device, dtype=self.dtype)

    def put(self, name, t):
        if name in self.out:
            raise ValueError(f"{name} produced twice")
        if self.shard is not None:
            t = self.shard(name, t).to(device=self.device, dtype=self.dtype)
        elif isinstance(t, RowCat):
            t = t.whole()
        self.out[name] = t

    def weight_bias(self, src):
        """A linear's weight and bias; a missing bias is zeros (the JAX
        converter's rule)."""
        w = self.get(f"{src}.weight")
        if w.dim() == 4:                # old 1x1-conv style
            w = w[:, :, 0, 0]
        b = f"{src}.bias"
        return w, (self.get(b) if b in self.state else
                   torch.zeros(w.shape[0], device=w.device, dtype=w.dtype))

    def lin(self, dst, src):
        w, b = self.weight_bias(src)
        self.put(f"{dst}.weight", w)
        self.put(f"{dst}.bias", b)

    def copy(self, dst, src):
        self.put(dst, self.get(src))

    def embed(self, dst, src):
        self.lin(f"{dst}.in_", f"{src}.linear_1")
        self.lin(f"{dst}.out", f"{src}.linear_2")

    def check_consumed(self, what, hint, ignore=()):
        left = self.state.unconsumed(ignore)
        if left:
            raise ValueError(f"{what}: {len(left)} unmapped tensors, e.g. "
                             f"{sorted(left)[:5]} — {hint}")


def convert_connector(state, ccfg, device="cuda",
                      prefix: str = "connector.") -> dict:
    """Step1X-Edit `Qwen2Connector` tensors (inside the transformer
    checkpoint under `connector.*`) -> the port's `connector.*` names:
      S.input_embedder -> in_proj, S.t_embedder.mlp.{0,2} -> t_embed,
      S.c_embedder.linear_{1,2} -> c_embed, global_proj_out ->
      global_proj, scale_factor; per block S.individual_token_refiner.
      blocks.{i}: norm1 / norm2 (affine LayerNorm), self_attn_qkv ([3h, h],
      split by rows) -> attn.{q,k,v}, self_attn_proj -> attn.out, mlp.fc1 /
      fc2 -> mlp, adaLN_modulation.1 -> mod."""
    c = state if isinstance(state, _Converter) else _Converter(
        state, device, ccfg.dtype)
    h = ccfg.hidden
    c.lin("connector.in_proj", f"{prefix}S.input_embedder")
    c.lin("connector.t_embed.in_", f"{prefix}S.t_embedder.mlp.0")
    c.lin("connector.t_embed.out", f"{prefix}S.t_embedder.mlp.2")
    c.embed("connector.c_embed", f"{prefix}S.c_embedder")
    c.lin("connector.global_proj", f"{prefix}global_proj_out")
    c.put("connector.scale_factor",
          c.get(f"{prefix}scale_factor").reshape(1))
    for i in range(ccfg.depth):
        src = f"{prefix}S.individual_token_refiner.blocks.{i}"
        dst = f"connector.blocks.{i}"
        for n in ("norm1", "norm2"):
            c.copy(f"{dst}.{n}.scale", f"{src}.{n}.weight")
            c.copy(f"{dst}.{n}.bias", f"{src}.{n}.bias")
        w = c.get(f"{src}.self_attn_qkv.weight")
        b = c.get(f"{src}.self_attn_qkv.bias")
        for k, name in enumerate(("q", "k", "v")):
            c.put(f"{dst}.attn.{name}.weight", w[k * h:(k + 1) * h])
            c.put(f"{dst}.attn.{name}.bias", b[k * h:(k + 1) * h])
        c.lin(f"{dst}.attn.out", f"{src}.self_attn_proj")
        c.lin(f"{dst}.mlp.in_", f"{src}.mlp.fc1")
        c.lin(f"{dst}.mlp.out", f"{src}.mlp.fc2")
        c.lin(f"{dst}.mod", f"{src}.adaLN_modulation.1")
    return c.out


# Step1X-Edit's top-level naming against FluxTransformer2DModel
STEP1X_ALIASES: list[tuple[str, str]] = [
    (r"^time_embed\.", "time_text_embed.timestep_embedder."),
    (r"^vec_embed\.", "time_text_embed.text_embedder."),
]


def is_step1x_state(state: dict) -> bool:
    return any(k.startswith("connector.") or k.startswith("time_embed.")
               for k in state)


def normalize_step1x_keys(state: dict) -> dict:
    out = {}
    for k, v in state.items():
        nk = k
        for pat, rep in STEP1X_ALIASES:
            nk = re.sub(pat, rep, nk)
        out[nk] = v
    return out


# Qwen-Image's block naming -> the FLUX names above (its MMDiT is
# joint-double-stream only, each tensor's role one-to-one with the double
# block's)
QWEN_ALIASES: list[tuple[str, str]] = [
    (r"\.img_mod\.1", ".norm1.linear"),
    (r"\.txt_mod\.1", ".norm1_context.linear"),
    (r"\.img_mlp\.net\.0\.proj", ".ff.net.0.proj"),
    (r"\.img_mlp\.net\.2", ".ff.net.2"),
    (r"\.txt_mlp\.net\.0\.proj", ".ff_context.net.0.proj"),
    (r"\.txt_mlp\.net\.2", ".ff_context.net.2"),
    (r"time_text_embed\.timestep_embedder", "time_text_embed.timestep_embedder"),
    (r"^img_in", "x_embedder"),
    (r"^txt_in", "context_embedder"),
]


def is_qwen_state(state: dict) -> bool:
    return any(k.startswith("img_in") or ".img_mod." in k for k in state)


def normalize_qwen_keys(state: dict) -> dict:
    out = {}
    for k, v in state.items():
        nk = k
        for pat, rep in QWEN_ALIASES:
            nk = re.sub(pat, rep, nk)
        out[nk] = v
    return out


def convert_flux_transformer(state, cfg, device="cuda", shard=None) -> dict:
    """diffusers FluxTransformer2DModel / Step1X-Edit transformer tensors
    (FLUX names; `normalize_*_keys` first for the Step1X and Qwen namings)
    -> the port's `MMDiT` state dict on `device`, in `cfg.dtype` (the
    connector in its own config's dtype).  Every source tensor must be
    consumed.  `shard`: a tensor-parallel rank's cut (`_Converter`)."""
    c = _Converter(state, device, cfg.dtype, shard)
    c.lin("x_embedder", "x_embedder")
    c.lin("txt_in", "context_embedder")
    if cfg.txt_norm:
        c.copy("txt_norm.scale", "txt_norm.weight")
    c.embed("time_in", "time_text_embed.timestep_embedder")
    c.lin("final_proj", "proj_out")
    if cfg.pooled_dim and \
            "time_text_embed.text_embedder.linear_1.weight" in c.state:
        c.embed("vector_in", "time_text_embed.text_embedder")
    if cfg.guidance_embed:
        c.embed("guidance_in", "time_text_embed.guidance_embedder")
    # [scale, shift] -> [shift, scale]
    for leaf, t in zip(("weight", "bias"), c.weight_bias("norm_out.linear")):
        h = t.shape[0] // 2
        c.put(f"final_mod.{leaf}", RowCat([t[h:], t[:h]]))

    attn = {"img_attn": ("to_q", "to_k", "to_v", "to_out.0", "norm_q",
                         "norm_k"),
            "txt_attn": ("add_q_proj", "add_k_proj", "add_v_proj",
                         "to_add_out", "norm_added_q", "norm_added_k")}
    for i in range(cfg.depth_double):
        src, dst = f"transformer_blocks.{i}", f"double_blocks.{i}"
        c.lin(f"{dst}.img_mod", f"{src}.norm1.linear")
        c.lin(f"{dst}.txt_mod", f"{src}.norm1_context.linear")
        for stream, names in attn.items():
            for name, s in zip(("q", "k", "v", "out"), names):
                c.lin(f"{dst}.{stream}.{name}", f"{src}.attn.{s}")
            c.copy(f"{dst}.{stream}.norm_q.scale",
                   f"{src}.attn.{names[4]}.weight")
            c.copy(f"{dst}.{stream}.norm_k.scale",
                   f"{src}.attn.{names[5]}.weight")
        for stream, s in (("img_mlp", "ff"), ("txt_mlp", "ff_context")):
            c.lin(f"{dst}.{stream}.in_", f"{src}.{s}.net.0.proj")
            c.lin(f"{dst}.{stream}.out", f"{src}.{s}.net.2")

    for i in range(cfg.depth_single):
        src, dst = f"single_transformer_blocks.{i}", f"single_blocks.{i}"
        c.lin(f"{dst}.mod", f"{src}.norm.linear")
        parts = [c.weight_bias(f"{src}.{s}") for s in
                 ("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp")]
        for k, leaf in enumerate(("weight", "bias")):
            c.put(f"{dst}.linear1.{leaf}", RowCat([p[k] for p in parts]))
        c.lin(f"{dst}.linear2", f"{src}.proj_out")
        c.copy(f"{dst}.norm_q.scale", f"{src}.attn.norm_q.weight")
        c.copy(f"{dst}.norm_k.scale", f"{src}.attn.norm_k.weight")

    if cfg.connector is not None:
        conn = _Converter(c.state, device, cfg.connector.dtype, shard)
        conn.out = c.out            # in the connector's dtype, into c's
        convert_connector(conn, cfg.connector, device)
    c.check_consumed("convert_flux_transformer",
                     "mapping incomplete or wrong preset for this checkpoint")
    return c.out


def convert_vae(state, vae_cfg, device="cuda") -> dict:
    """diffusers AutoencoderKL tensors -> the port's `AutoencoderKL` state
    dict (torch conv layouts kept; the mid attention's q/k/v/out are
    linears, from 1x1 convs in older checkpoints).  Every tensor must be
    consumed: the flux-family AutoencoderKL has no quant / post_quant convs,
    so a checkpoint that has them is another architecture and is refused,
    not silently dropped."""
    c = _Converter(state, device, vae_cfg.dtype)

    def conv(dst, src):
        c.copy(f"{dst}.weight", f"{src}.weight")
        c.copy(f"{dst}.bias", f"{src}.bias")

    def gn(dst, src):
        c.copy(f"{dst}.scale", f"{src}.weight")
        c.copy(f"{dst}.bias", f"{src}.bias")

    def resnet(dst, src):
        gn(f"{dst}.norm1", f"{src}.norm1")
        conv(f"{dst}.conv1", f"{src}.conv1")
        gn(f"{dst}.norm2", f"{src}.norm2")
        conv(f"{dst}.conv2", f"{src}.conv2")
        if f"{src}.conv_shortcut.weight" in c.state:
            conv(f"{dst}.shortcut", f"{src}.conv_shortcut")

    def mid(dst, src):
        resnet(f"{dst}.res1", f"{src}.resnets.0")
        a, s = f"{dst}.attn", f"{src}.attentions.0"
        gn(f"{a}.norm", f"{s}.group_norm")
        for name, sub in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                          ("out", "to_out.0")):
            c.lin(f"{a}.{name}", f"{s}.{sub}")
        resnet(f"{dst}.res2", f"{src}.resnets.1")

    n = vae_cfg.layers_per_block
    for part, levels, blocks, res in (("encoder", "down", "down_blocks",
                                       "downsample"),
                                      ("decoder", "up", "up_blocks",
                                       "upsample")):
        conv(f"{part}.conv_in", f"{part}.conv_in")
        gn(f"{part}.norm_out", f"{part}.conv_norm_out")
        conv(f"{part}.conv_out", f"{part}.conv_out")
        mid(f"{part}.mid", f"{part}.mid_block")
        sampler = "downsamplers" if part == "encoder" else "upsamplers"
        for i in range(len(vae_cfg.block_out_channels)):
            for j in range(n + (part == "decoder")):
                resnet(f"{part}.{levels}.{i}.resnets.{j}",
                       f"{part}.{blocks}.{i}.resnets.{j}")
            src = f"{part}.{blocks}.{i}.{sampler}.0.conv"
            if f"{src}.weight" in c.state:
                conv(f"{part}.{levels}.{i}.{res}", src)
    c.check_consumed("convert_vae", "the flux-family AutoencoderKL has no "
                     "quant/post_quant convs; a checkpoint that does needs "
                     "them modeled, not dropped")
    return c.out


def _fold_causal3d(w):
    """WanCausalConv3d weight [out, in, kt, kh, kw] -> the one-frame 2-D
    kernel [out, in, kh, kw]: the causal conv pads kt - 1 zero frames in
    front, so on one frame only the last tap meets data."""
    if w.dim() != 5:
        raise ValueError(f"a causal 3-D conv weight is 5-D, got {w.shape}")
    return w[:, :, -1].contiguous()


def convert_wan_vae(state, cfg, device="cuda") -> dict:
    """diffusers AutoencoderKLWan tensors -> the port's `WanVAE` state dict
    (one-frame 2-D fold; the time_conv resample weights act only on video
    and are left unused).  The flattened down_blocks / up_blocks ModuleList
    mixes residual and resample blocks: each index is classified by its
    keys."""
    c = _Converter(state, device, cfg.dtype)

    def conv(dst, src):
        w = c.get(f"{src}.weight")
        c.put(f"{dst}.weight", _fold_causal3d(w) if w.dim() == 5 else w)
        c.copy(f"{dst}.bias", f"{src}.bias")

    def rms(dst, src):
        c.put(f"{dst}.gamma", c.get(f"{src}.gamma").reshape(-1))
        if f"{src}.bias" in c.state:
            c.put(f"{dst}.bias", c.get(f"{src}.bias").reshape(-1))

    def resnet(dst, src):
        rms(f"{dst}.norm1", f"{src}.norm1")
        conv(f"{dst}.conv1", f"{src}.conv1")
        rms(f"{dst}.norm2", f"{src}.norm2")
        conv(f"{dst}.conv2", f"{src}.conv2")
        if f"{src}.conv_shortcut.weight" in c.state:
            conv(f"{dst}.shortcut", f"{src}.conv_shortcut")

    def mid(dst, src):
        resnet(f"{dst}.res1", f"{src}.resnets.0")
        rms(f"{dst}.attn.norm", f"{src}.attentions.0.norm")
        c.lin(f"{dst}.attn.qkv", f"{src}.attentions.0.to_qkv")
        c.lin(f"{dst}.attn.proj", f"{src}.attentions.0.proj")
        resnet(f"{dst}.res2", f"{src}.resnets.1")

    def levels(dst, src, n_res, resample):
        idx = 0
        for lvl in range(len(cfg.dim_mult)):
            for j in range(n_res):
                resnet(f"{dst}.{lvl}.resnets.{j}", f"{src}.{idx}")
                idx += 1
            if f"{src}.{idx}.resample.1.weight" in c.state:
                conv(f"{dst}.{lvl}.{resample}", f"{src}.{idx}.resample.1")
                idx += 1

    conv("encoder.conv_in", "encoder.conv_in")
    levels("encoder.down", "encoder.down_blocks", cfg.num_res_blocks,
           "downsample")
    mid("encoder.mid", "encoder.mid_block")
    rms("encoder.norm_out", "encoder.norm_out")
    conv("encoder.conv_out", "encoder.conv_out")
    conv("encoder.quant_conv", "quant_conv")
    conv("decoder.post_quant_conv", "post_quant_conv")
    conv("decoder.conv_in", "decoder.conv_in")
    mid("decoder.mid", "decoder.mid_block")
    levels("decoder.up", "decoder.up_blocks", cfg.num_res_blocks + 1,
           "upsample")
    rms("decoder.norm_out", "decoder.norm_out")
    conv("decoder.conv_out", "decoder.conv_out")
    c.check_consumed("convert_wan_vae",
                     "mapping incomplete or wrong checkpoint",
                     ignore=(r"\btime_conv\b", r"\.time_conv\."))
    return c.out


def is_wan_vae_state(state: dict) -> bool:
    return any(k.endswith("norm1.gamma") or k == "encoder.norm_out.gamma"
               for k in state)


def _module_from_state(cls, cfg, state):
    """`cls(cfg)` built on the meta device, holding `state`'s tensors."""
    mod = cls(cfg, torch.device("meta"))
    mod.load_state_dict(state, strict=True, assign=True)
    return mod.eval()


def load_converted(model_path, cfg, backend: str | None = None,
                   load_text_encoder: bool = True, device="cuda", mesh=None,
                   weights: dict | None = None):
    """Load a diffusers-layout checkpoint directory:
      <model_path>/transformer/*.safetensors
      <model_path>/vae/*.safetensors (+ config.json)
      <model_path>/text_encoder/ (+ processor / tokenizer subfolders)
    Returns (MMDiT, VAE config, VAE module, prompt encoder), on `device`.

    With `backend`, the prompt encoder is the backend's reference recipe
    (`text_encoders.encoder_from_checkpoint`: chat template and prefix drop
    for the Qwen family, T5 + CLIP for FLUX); otherwise the generic
    `HFTextEncoder`; with no text_encoder/ (or load_text_encoder=False) the
    mock encoder.

    `mesh`: a (dp, tp) mesh (`parallel.sharding.make_mesh`): the MMDiT is
    this rank's shard, read from the files slice by slice (its
    `loaded_bytes`: the bytes read for it).

    The prompt encoder's placement ("card", "offload" or "host",
    `text_encoders`) is `auto_placement`'s: `utils.memplan.choose_placement`
    for this checkpoint's encoder beside `cfg`'s weights (in the format
    `weights` names: `memplan.plan`'s int8 / bits / quantize_mods /
    int4_mods, the one the denoise will hold) on `device`'s card, decided
    before anything is loaded and logged on a line of its own."""
    from regione_tpu_torch.models.mmdit import MMDiT
    from regione_tpu_torch.models.text_encoders import (
        HFTextEncoder, MockTextEncoder, encoder_from_checkpoint)
    from regione_tpu_torch.models.vae import VAEConfig, vae_module
    from regione_tpu_torch.models.vae_wan import WanVAEConfig

    root = Path(model_path)
    if load_text_encoder and backend is not None:
        placement = auto_placement(root, cfg, backend, device, mesh, weights)
    state = _load_torch_state(root / "transformer")
    if is_qwen_state(state):
        state = normalize_qwen_keys(state)
    if is_step1x_state(state):
        state = normalize_step1x_keys(state)
    if mesh is None:
        model = _module_from_state(MMDiT, cfg, convert_flux_transformer(
            state, cfg, device))
    else:
        model = load_shards(
            MMDiT(cfg, torch.device("meta")), mesh,
            lambda shard: convert_flux_transformer(state, cfg, device, shard))
    del state

    vae_state = _load_torch_state(root / "vae")
    vcfg_file = root / "vae" / "config.json"
    c = json.loads(vcfg_file.read_text()) if vcfg_file.exists() else {}
    if is_wan_vae_state(vae_state) or \
            c.get("_class_name") == "AutoencoderKLWan":
        kw = {}
        if "latents_mean" in c:
            kw["latents_mean"] = tuple(c["latents_mean"])
            kw["latents_std"] = tuple(c["latents_std"])
        vae_cfg = WanVAEConfig(
            latent_channels=c.get("z_dim", 16),
            base_dim=c.get("base_dim", 96),
            dim_mult=tuple(c.get("dim_mult", (1, 2, 4, 4))),
            num_res_blocks=c.get("num_res_blocks", 2), **kw)
        vae_sd = convert_wan_vae(vae_state, vae_cfg, device)
    else:
        vae_cfg = VAEConfig(
            latent_channels=c.get("latent_channels", 16),
            block_out_channels=tuple(
                c.get("block_out_channels", (128, 256, 512, 512))),
            layers_per_block=c.get("layers_per_block", 2),
            norm_num_groups=c.get("norm_num_groups", 32),
            scaling_factor=c.get("scaling_factor", 0.3611),
            shift_factor=c.get("shift_factor", 0.1159) or 0.0)
        vae_sd = convert_vae(vae_state, vae_cfg, device)
    vae = _module_from_state(vae_module(vae_cfg), vae_cfg, vae_sd)

    te_dir = root / "text_encoder"
    if not load_text_encoder or not te_dir.exists():
        encoder = MockTextEncoder(cfg.txt_in_dim, cfg.pooled_dim or None)
    elif backend is not None:
        encoder = encoder_from_checkpoint(root, backend, device=device,
                                          placement=placement)
    else:
        encoder = HFTextEncoder(str(te_dir), device=device)
    return model, vae_cfg, vae, encoder


def auto_placement(root, cfg, backend: str, device, mesh=None,
                   weights: dict | None = None) -> str:
    """`utils.memplan.choose_placement` for the text encoder of the
    checkpoint at `root` beside `cfg`'s weights on `device`'s card (its
    total memory), at tp = the mesh's; logged on its own line.  "card" off
    the card (a CPU run places nothing) or with no text encoder."""
    import sys

    from regione_tpu_torch.utils import memplan
    device = torch.device(device)
    encoder = memplan.checkpoint_encoder(root, backend)
    if device.type != "cuda" or encoder is None:
        return "card"
    hbm = torch.cuda.get_device_properties(device).total_memory
    tp = mesh.size(1) if mesh is not None else 1
    placement, p = memplan.choose_placement(
        cfg, encoder, hbm, batch_cfg=1 if backend == "flux-kontext" else 2,
        tp=tp, **(weights or {}))
    gib = 2 ** 30
    print(f"[load] prompt encoder placement: {placement} (memplan at grid "
          f"{p.grid}, t_txt {p.t_txt}, tp {tp}: weights "
          f"{p.param_bytes / gib:.2f} + encoder {p.encoder_bytes / gib:.2f} "
          f"+ cache {p.cache_bytes / gib:.2f} + activations "
          f"{p.activation_bytes_est / gib:.2f} = {p.total_bytes / gib:.2f} "
          f"GiB on a {hbm / gib:.2f} GiB card)", file=sys.stderr, flush=True)
    return placement


def main(argv=None):
    """Offline conversion: a diffusers checkpoint directory -> the port's
    safetensors state dicts <out>/transformer.safetensors and
    <out>/vae.safetensors (the prompt encoder is not converted)."""
    import argparse

    from regione_tpu_torch.models.presets import get_config
    from regione_tpu_torch.weights import checkpoint

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--backend", default="step1x-edit")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="where the tensors are converted (default cuda)")
    args = ap.parse_args(argv)
    model, vae_cfg, vae, _ = load_converted(
        args.model_path, get_config(args.backend), load_text_encoder=False,
        device=args.device)
    checkpoint.save(Path(args.out) / "transformer.safetensors",
                    model.state_dict())
    checkpoint.save(Path(args.out) / "vae.safetensors", vae.state_dict())
    print(f"converted {args.backend} -> {args.out} "
          f"(vae latent_channels={vae_cfg.latent_channels})")


if __name__ == "__main__":
    main()
