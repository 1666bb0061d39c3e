"""Hand-written CUDA kernels of the port, each beside its plain
PyTorch version and with a launch count on its wrapper."""

from unet_bssfp_tpu_torch.ops.kernels.conv3d import (
    conv3x3_packed,
    conv3x3_packed_auto,
    conv3x3_packed_dgrad,
    conv3x3_packed_halo,
    conv3x3_packed_halo_dgrad,
    conv3x3_packed_halo_dgrad_plain,
    conv3x3_packed_halo_plain,
    conv3x3_packed_mma,
    conv3x3_packed_mma_routed,
    conv3x3_packed_plain,
    conv_plan,
    guard_mask,
    conv3x3_wgrad,
    conv3x3_wgrad_chain,
    conv3x3_wgrad_halo,
    conv3x3_wgrad_halo_plain,
    conv3x3_wgrad_mma,
    conv3x3_wgrad_mma_chain,
    conv3x3_wgrad_mma_routed,
    conv3x3_wgrad_plain,
    packed_supported,
    strip_guards,
    wgrad_plan,
)
from unet_bssfp_tpu_torch.ops.kernels.layout import (
    pack_hw,
    pack_hw_auto,
    pack_hw_plain,
    unpack_hw,
    unpack_hw_auto,
    unpack_hw_plain,
)
from unet_bssfp_tpu_torch.ops.kernels.norm_act import (
    fused_instance_norm_leaky_relu,
    instance_norm_leaky_relu_plain,
)
from unet_bssfp_tpu_torch.ops.kernels.packed_norm_act import (
    packed_norm_act,
    packed_norm_act_backward,
    packed_norm_act_model,
    packed_norm_act_plain,
)
from unet_bssfp_tpu_torch.ops.kernels.pfold import (
    conv3x3_pfold,
    conv3x3_pfold_dgrad,
    conv3x3_pfold_dgrad_plain,
    conv3x3_pfold_halo,
    conv3x3_pfold_halo_dgrad,
    conv3x3_pfold_halo_dgrad_plain,
    conv3x3_pfold_halo_plain,
    conv3x3_pfold_plain,
    conv3x3_pfold_wgrad,
    conv3x3_pfold_wgrad_chain,
    conv3x3_pfold_wgrad_halo,
    conv3x3_pfold_wgrad_halo_plain,
    conv3x3_pfold_wgrad_plain,
    fold4_pack,
    pfold_supported,
    unfold4_unpack,
)
from unet_bssfp_tpu_torch.ops.kernels.probe import (
    PROBE_MODES,
    conv3x3_probe_centre,
    conv3x3_probe_fixed,
    conv3x3_probe_full,
    conv3x3_probe_plain,
    lane_roll,
    lane_roll_plain,
)
from unet_bssfp_tpu_torch.ops.kernels.scalar_maps import scalar_maps, scalar_maps_plain, scalar_maps_plan
from unet_bssfp_tpu_torch.ops.window_attention import window_attention

WRAPPERS = (conv3x3_packed, conv3x3_packed_dgrad, conv3x3_wgrad,
            conv3x3_packed_halo, conv3x3_packed_halo_dgrad, conv3x3_wgrad_halo,
            conv3x3_packed_mma, conv3x3_packed_mma_routed,
            conv3x3_wgrad_mma, conv3x3_wgrad_mma_routed,
            pack_hw, unpack_hw, fused_instance_norm_leaky_relu, scalar_maps,
            conv3x3_pfold, conv3x3_pfold_dgrad, conv3x3_pfold_wgrad,
            conv3x3_pfold_halo, conv3x3_pfold_halo_dgrad, conv3x3_pfold_wgrad_halo,
            lane_roll, conv3x3_probe_full, conv3x3_probe_centre, conv3x3_probe_fixed,
            packed_norm_act, packed_norm_act_backward, window_attention)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
