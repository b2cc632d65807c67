"""Model modules of the port, registered by network name in `core/registry.MODELS`
(as `posecnn_tpu/models/__init__.py:23-29` registers them)."""
from posecnn_torch.core.registry import MODELS
from posecnn_torch.models.detection import PoseCNNDet
from posecnn_torch.models.fcn8 import FCN8
from posecnn_torch.models.posecnn import PoseCNN
from posecnn_torch.models.recurrent import RecurrentSegNet
from posecnn_torch.models.resnet50 import ResNet50Seg

MODELS.register("posecnn", PoseCNN)
MODELS.register("posecnn_det", PoseCNNDet)
MODELS.register("recurrent_seg", RecurrentSegNet)
MODELS.register("resnet50_seg", ResNet50Seg)
MODELS.register("fcn8", FCN8)
