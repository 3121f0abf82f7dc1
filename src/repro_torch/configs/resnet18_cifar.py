"""The paper's own experiment config (``repro.configs.resnet18_cifar``):
ResNet18 on CIFAR-10-class data with the Goyal large-batch recipe (§V-B):
per-MU batch 64, base lr 0.1 @ batch 128 scaled to the cumulative batch,
5-epoch gradual warm-up, x0.1 drops at epochs 150/225 of 300, momentum
0.9, weight decay 1e-4 (not on BN), β_m=0.2, β_s=0.5,
φ = (0.99, 0.9, 0.9, 0.9).

The port carries no legacy scalar ``HFLConfig`` keywords, so the geometry
is written as tiers: φ_MU^ul / φ_SBS^dl are ``tiers[0].phi_up/phi_down``,
φ_SBS^ul / φ_MBS^dl ``tiers[1].phi_up/phi_down``, β_s / β_m
``tiers[1].beta_up/beta_down``.
"""
from dataclasses import dataclass, field

from repro_torch.configs.base import HFLConfig, TierConfig


@dataclass(frozen=True)
class PaperTrainConfig:
    num_classes: int = 10
    width: float = 1.0  # channel scale (use <1 for CPU-scale runs)
    batch_per_mu: int = 64
    base_lr: float = 0.1
    base_batch: int = 128
    epochs: int = 300
    warmup_epochs: int = 5
    decay_epochs: tuple = (150, 225)
    momentum: float = 0.9
    weight_decay: float = 1e-4
    hfl: HFLConfig = field(
        default_factory=lambda: HFLConfig(
            tiers=(TierConfig(fanout=4, period=1, phi_up=0.99, phi_down=0.9),
                   TierConfig(fanout=7, period=4, phi_up=0.9, phi_down=0.9,
                              beta_up=0.5, beta_down=0.2)),
            momentum=0.9,
        )
    )

    def scaled_lr(self) -> float:
        k = self.hfl.total_mus
        return self.base_lr * (k * self.batch_per_mu) / self.base_batch


CONFIG = PaperTrainConfig()
