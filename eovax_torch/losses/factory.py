"""Stage-2 loss construction from a config dict.

Port of the ``EOConsistencyLoss`` branch of ``eovax/losses/factory.py``. The
adversarial losses (``EOPatchLoss``, ``EOGenerativeLoss``) and DOFA, which
feeds the feature term, are not ported yet (ROADMAP Queue 1 item 4): a DOFA
feature term whose checkpoint is not on disk is disabled, as in the JAX
package; one whose checkpoint is there raises.
"""

from __future__ import annotations

import os

from eovax_torch.losses.consistency import EOConsistencyLoss


def build_loss_from_config(loss_cfg: dict | None) -> EOConsistencyLoss:
    """The stage-2 loss named by ``loss_cfg['_target_']`` (empty: the consistency loss)."""
    loss_cfg = dict(loss_cfg or {})
    target = loss_cfg.pop("_target_", "") or ""
    if target.endswith(("EOPatchLoss", "EOGenerativeLoss")):
        raise NotImplementedError(
            f"{target.rsplit('.', 1)[-1]} (an adversarial loss) is not ported yet: "
            "ROADMAP Queue 1 item 4")
    if target and not target.endswith("EOConsistencyLoss"):
        raise ValueError(f"Unknown loss _target_: {target}")
    loss_cfg.pop("discriminator", None)
    dofa_cfg = loss_cfg.pop("dofa_net", None)
    if loss_cfg.get("feature_weight", 0) > 0 and dofa_cfg is not None:
        ckpt = dofa_cfg.get("ckpt_data") or dofa_cfg.get("weights_path")
        if ckpt and os.path.exists(ckpt):
            raise NotImplementedError(
                f"DOFA (the feature term's network, checkpoint {ckpt!r}) is not ported yet: "
                "ROADMAP Queue 1 item 4")
        print(
            f"[losses.factory] DOFA checkpoint {ckpt!r} not found — "
            "perceptual/feature term disabled (supply a converted ckpt to enable)"
        )
        loss_cfg["feature_weight"] = 0.0
    return EOConsistencyLoss.from_dict(loss_cfg)
