"""The paper's own experiment models (scaled for CPU-feasible reproduction;
the port's copy of the reference's ``configs/paper_models.py``).

SPA's headline tables use ResNet-18/50/101, VGG-16/19, ViT-b16 and
DistilBERT.  We register CIFAR-scale CNN configs plus mini transformer
encoder configs (``vit-mini`` = patch-embedding encoder, ``distilbert-mini``
= token encoder) so every paper table has a runnable counterpart.
"""
from repro_torch.configs.base import ArchConfig, register


@register("resnet18-cifar")
def resnet18_cifar() -> ArchConfig:
    return ArchConfig(
        name="resnet18-cifar",
        family="cnn",
        cnn_kind="resnet",
        cnn_stem=64,
        cnn_stages=((64, 2), (128, 2), (256, 2), (512, 2)),
        num_classes=10,
        image_size=32,
        dtype="float32",
    )


@register("resnet50-cifar")
def resnet50_cifar() -> ArchConfig:
    # Basic-block ResNet depth-50-ish at CIFAR scale (bottlenecks add no new
    # coupling patterns beyond what resnet18 + vgg exercise).
    return ArchConfig(
        name="resnet50-cifar",
        family="cnn",
        cnn_kind="resnet",
        cnn_stem=64,
        cnn_stages=((64, 3), (128, 4), (256, 6), (512, 3)),
        num_classes=10,
        image_size=32,
        dtype="float32",
    )


@register("vgg19-cifar")
def vgg19_cifar() -> ArchConfig:
    return ArchConfig(
        name="vgg19-cifar",
        family="cnn",
        cnn_kind="vgg",
        cnn_stem=64,
        # (channels, convs) per stage, maxpool between stages — VGG-19 layout
        cnn_stages=((64, 2), (128, 2), (256, 4), (512, 4), (512, 4)),
        num_classes=100,
        image_size=32,
        dtype="float32",
    )


@register("vit-mini")
def vit_mini() -> ArchConfig:
    # Patch-embedding encoder; "vision_tokens" doubles as the patch count.
    return ArchConfig(
        name="vit-mini",
        family="audio",          # reuses the encoder-backbone path
        num_layers=6,
        d_model=256,
        n_heads=8,
        n_kv_heads=8,
        head_dim=32,
        d_ff=1024,
        vocab_size=10,           # classifier classes
        is_encoder=True,
        audio_frontend=True,     # stub frame/patch embeddings in
        dtype="float32",
        remat=False,
    )


@register("distilbert-mini")
def distilbert_mini() -> ArchConfig:
    return ArchConfig(
        name="distilbert-mini",
        family="audio",
        num_layers=6,
        d_model=256,
        n_heads=8,
        n_kv_heads=8,
        head_dim=32,
        d_ff=1024,
        vocab_size=2,            # SST-2 sentiment classes
        is_encoder=True,
        audio_frontend=True,
        dtype="float32",
        remat=False,
    )
