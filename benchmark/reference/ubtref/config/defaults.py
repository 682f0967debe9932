"""Default configuration (copy of ubteacher_tpu.config.defaults).

Mirrors the config surface the reference reads: the detectron2 v0.6 defaults
it relies on plus `add_ubteacher_config` (reference: ubteacher/config.py:7-219).
Every key of the JAX package is kept, including the `TPU.*` block, so the
same yaml files load into both packages.
"""

from .cfg import CfgNode as CN


def _detectron2_subset_defaults() -> CN:
    """The subset of detectron2's default config that this framework reads.

    Key names and default values follow detectron2 v0.6 so that the
    reference's yaml configs load unmodified (reference: configs/*).
    """
    _C = CN()
    _C.VERSION = 2
    _C.OUTPUT_DIR = "./output"
    _C.SEED = -1
    _C.CUDNN_BENCHMARK = False

    _C.MODEL = CN()
    _C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    _C.MODEL.WEIGHTS = ""
    _C.MODEL.MASK_ON = False
    _C.MODEL.KEYPOINT_ON = False
    _C.MODEL.LOAD_PROPOSALS = False
    _C.MODEL.DEVICE = "tpu"
    # BGR order, caffe2-style ImageNet pixel statistics (D2 default)
    _C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]

    _C.MODEL.BACKBONE = CN()
    _C.MODEL.BACKBONE.NAME = "build_resnet_backbone"
    _C.MODEL.BACKBONE.FREEZE_AT = 2

    _C.MODEL.RESNETS = CN()
    _C.MODEL.RESNETS.DEPTH = 50
    _C.MODEL.RESNETS.OUT_FEATURES = ["res4"]
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = True  # caffe/MSRA variant
    _C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    _C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64

    _C.MODEL.FPN = CN()
    _C.MODEL.FPN.IN_FEATURES = []
    _C.MODEL.FPN.OUT_CHANNELS = 256
    _C.MODEL.FPN.NORM = ""
    _C.MODEL.FPN.FUSE_TYPE = "sum"

    _C.MODEL.PROPOSAL_GENERATOR = CN()
    _C.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"
    _C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

    _C.MODEL.ANCHOR_GENERATOR = CN()
    _C.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    _C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    _C.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0

    _C.MODEL.RPN = CN()
    _C.MODEL.RPN.HEAD_NAME = "StandardRPNHead"
    _C.MODEL.RPN.IN_FEATURES = ["res4"]
    _C.MODEL.RPN.BOUNDARY_THRESH = -1
    _C.MODEL.RPN.IOU_THRESHOLDS = [0.3, 0.7]
    _C.MODEL.RPN.IOU_LABELS = [0, -1, 1]
    _C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    _C.MODEL.RPN.POSITIVE_FRACTION = 0.5
    _C.MODEL.RPN.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.RPN.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    _C.MODEL.RPN.SMOOTH_L1_BETA = 0.0
    _C.MODEL.RPN.LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 12000
    _C.MODEL.RPN.PRE_NMS_TOPK_TEST = 6000
    _C.MODEL.RPN.POST_NMS_TOPK_TRAIN = 2000
    _C.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
    _C.MODEL.RPN.NMS_THRESH = 0.7
    _C.MODEL.RPN.CONV_DIMS = [-1]

    _C.MODEL.ROI_HEADS = CN()
    _C.MODEL.ROI_HEADS.NAME = "Res5ROIHeads"
    _C.MODEL.ROI_HEADS.NUM_CLASSES = 80
    _C.MODEL.ROI_HEADS.IN_FEATURES = ["res4"]
    _C.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
    _C.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
    _C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    _C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    _C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    _C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
    _C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True

    _C.MODEL.ROI_BOX_HEAD = CN()
    _C.MODEL.ROI_BOX_HEAD.NAME = ""
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    _C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
    _C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
    _C.MODEL.ROI_BOX_HEAD.NUM_FC = 0
    _C.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
    _C.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
    _C.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
    _C.MODEL.ROI_BOX_HEAD.NORM = ""
    _C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
    _C.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = False

    _C.MODEL.ROI_MASK_HEAD = CN()
    _C.MODEL.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsampleHead"
    _C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_MASK_HEAD.NUM_CONV = 0

    _C.INPUT = CN()
    _C.INPUT.MIN_SIZE_TRAIN = (800,)
    _C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    _C.INPUT.MAX_SIZE_TRAIN = 1333
    _C.INPUT.MIN_SIZE_TEST = 800
    _C.INPUT.MAX_SIZE_TEST = 1333
    _C.INPUT.RANDOM_FLIP = "horizontal"
    _C.INPUT.CROP = CN()
    _C.INPUT.CROP.ENABLED = False
    _C.INPUT.CROP.TYPE = "relative_range"
    _C.INPUT.CROP.SIZE = [0.9, 0.9]
    _C.INPUT.FORMAT = "BGR"
    _C.INPUT.MASK_FORMAT = "polygon"

    _C.DATASETS = CN()
    _C.DATASETS.TRAIN = ()
    _C.DATASETS.TEST = ()
    _C.DATASETS.PROPOSAL_FILES_TRAIN = ()
    _C.DATASETS.PROPOSAL_FILES_TEST = ()
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 1000

    _C.DATALOADER = CN()
    _C.DATALOADER.NUM_WORKERS = 4
    _C.DATALOADER.ASPECT_RATIO_GROUPING = True
    _C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
    _C.DATALOADER.REPEAT_THRESHOLD = 0.0
    _C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

    _C.SOLVER = CN()
    _C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
    _C.SOLVER.MAX_ITER = 40000
    _C.SOLVER.BASE_LR = 0.001
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.NESTEROV = False
    _C.SOLVER.WEIGHT_DECAY = 0.0001
    _C.SOLVER.WEIGHT_DECAY_NORM = 0.0
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = (30000,)
    _C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
    _C.SOLVER.WARMUP_ITERS = 1000
    _C.SOLVER.WARMUP_METHOD = "linear"
    _C.SOLVER.CHECKPOINT_PERIOD = 5000
    _C.SOLVER.IMS_PER_BATCH = 16
    _C.SOLVER.REFERENCE_WORLD_SIZE = 0
    _C.SOLVER.BIAS_LR_FACTOR = 1.0
    # None = biases inherit their module's decay (D2 v0.6 default: norm
    # biases get WEIGHT_DECAY_NORM, other biases WEIGHT_DECAY)
    _C.SOLVER.WEIGHT_DECAY_BIAS = None
    _C.SOLVER.CLIP_GRADIENTS = CN()
    _C.SOLVER.CLIP_GRADIENTS.ENABLED = False
    _C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
    _C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    _C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0
    _C.SOLVER.AMP = CN()
    _C.SOLVER.AMP.ENABLED = False

    _C.TEST = CN()
    _C.TEST.EVAL_PERIOD = 0
    _C.TEST.EXPECTED_RESULTS = []
    _C.TEST.KEYPOINT_OKS_SIGMAS = []
    _C.TEST.DETECTIONS_PER_IMAGE = 100
    _C.TEST.AUG = CN()
    _C.TEST.AUG.ENABLED = False
    _C.TEST.PRECISE_BN = CN()
    _C.TEST.PRECISE_BN.ENABLED = False

    _C.VIS_PERIOD = 0
    return _C


def add_ubteacher_config(cfg: CN) -> None:
    """Adds the semi-supervised keys (reference: ubteacher/config.py:7-219)."""
    _C = cfg
    _C.TEST.VAL_LOSS = True

    _C.MODEL.RPN.UNSUP_LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.LOSS = "CrossEntropy"
    _C.MODEL.ROI_HEADS.LOSS = "CrossEntropy"

    _C.SOLVER.IMG_PER_BATCH_LABEL = 1
    _C.SOLVER.IMG_PER_BATCH_UNLABEL = 1
    _C.SOLVER.FACTOR_LIST = (1,)

    _C.DATASETS.TRAIN_LABEL = ("coco_2017_train",)
    _C.DATASETS.TRAIN_UNLABEL = ("coco_2017_train",)
    _C.DATASETS.CROSS_DATASET = False
    _C.TEST.EVALUATOR = "COCOeval"
    # also report box-proposal AR{,s,m,l}@{100,1000} during RCNN eval
    # (the reference derives its "box_proposals" task from model outputs,
    # coco_evaluation.py:173-174; here it is an explicit switch)
    _C.TEST.EVAL_PROPOSALS = False

    _C.SEMISUPNET = CN()
    _C.SEMISUPNET.MLP_DIM = 128
    _C.SEMISUPNET.Trainer = "ubteacher"
    _C.SEMISUPNET.TEACHER_UPDATE_ITER = 1
    _C.SEMISUPNET.BURN_UP_STEP = 12000
    _C.SEMISUPNET.UNSUP_LOSS_WEIGHT = 4.0
    _C.SEMISUPNET.UNSUP_REG_LOSS_WEIGHT = 0.0
    _C.SEMISUPNET.SUP_LOSS_WEIGHT = 0.5
    _C.SEMISUPNET.LOSS_WEIGHT_TYPE = "standard"
    _C.SEMISUPNET.PROBE = True
    _C.SEMISUPNET.PSEUDO_CTR_THRES = 0.5
    _C.SEMISUPNET.EMA_SCHEDULE = False
    _C.SEMISUPNET.PSEUDO_CLS_IGNORE_NEAR = False
    _C.SEMISUPNET.SOFT_CLS_LABEL = False
    _C.SEMISUPNET.CLS_LOSS_METHOD = "focal"
    _C.SEMISUPNET.CLS_LOSS_PSEUDO_METHOD = "focal"
    _C.SEMISUPNET.REG_FG_THRES = 0.5

    _C.DATALOADER.SUP_PERCENT = 100.0
    _C.DATALOADER.RANDOM_DATA_SEED = 0
    _C.DATALOADER.RANDOM_DATA_SEED_PATH = "dataseed/COCO_supervision.txt"

    _C.EMAMODEL = CN()
    _C.EMAMODEL.SUP_CONSIST = True

    # FCOS head (reference: ubteacher/config.py:118-168)
    _C.MODEL.FCOS = CN()
    _C.MODEL.FCOS.NUM_CLASSES = 80
    _C.MODEL.FCOS.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
    _C.MODEL.FCOS.FPN_STRIDES = [8, 16, 32, 64, 128]
    _C.MODEL.FCOS.PRIOR_PROB = 0.01
    _C.MODEL.FCOS.INFERENCE_TH_TRAIN = 0.05
    _C.MODEL.FCOS.INFERENCE_TH_TEST = 0.05
    _C.MODEL.FCOS.NMS_TH = 0.6
    _C.MODEL.FCOS.PRE_NMS_TOPK_TRAIN = 1000
    _C.MODEL.FCOS.PRE_NMS_TOPK_TEST = 1000
    _C.MODEL.FCOS.POST_NMS_TOPK_TRAIN = 100
    _C.MODEL.FCOS.POST_NMS_TOPK_TEST = 100
    _C.MODEL.FCOS.TOP_LEVELS = 2
    _C.MODEL.FCOS.NORM = "GN"
    _C.MODEL.FCOS.USE_SCALE = True
    _C.MODEL.FCOS.THRESH_WITH_CTR = False
    _C.MODEL.FCOS.LOSS_ALPHA = 0.25
    _C.MODEL.FCOS.LOSS_GAMMA = 2.0
    _C.MODEL.FCOS.SIZES_OF_INTEREST = [64, 128, 256, 512]
    _C.MODEL.FCOS.USE_RELU = True
    _C.MODEL.FCOS.USE_DEFORMABLE = False
    _C.MODEL.FCOS.NUM_CLS_CONVS = 4
    _C.MODEL.FCOS.NUM_BOX_CONVS = 4
    _C.MODEL.FCOS.NUM_SHARE_CONVS = 0
    _C.MODEL.FCOS.CENTER_SAMPLE = True
    _C.MODEL.FCOS.POS_RADIUS = 1.5
    _C.MODEL.FCOS.LOC_LOSS_TYPE = "giou"
    _C.MODEL.FCOS.YIELD_PROPOSAL = False
    _C.MODEL.FCOS.NMS_CRITERIA_TRAIN = "cls"
    _C.MODEL.FCOS.NMS_CRITERIA_TEST = "cls_n_ctr"
    _C.MODEL.FCOS.NMS_CRITERIA_REG_TRAIN = "cls_n_loc"
    _C.MODEL.FCOS.REG_DISCRETE = False
    _C.MODEL.FCOS.DFL_WEIGHT = 0.0
    _C.MODEL.FCOS.LOC_FUN_ALL = "mean"
    _C.MODEL.FCOS.UNIFY_CTRCLS = False
    _C.MODEL.FCOS.REG_MAX = 16
    _C.MODEL.FCOS.QUALITY_EST = "centerness"
    _C.MODEL.FCOS.TSBETTER_CLS_SIGMA = 0.0
    _C.MODEL.FCOS.KL_LOSS = False
    _C.MODEL.FCOS.KL_LOSS_TYPE = "klloss"
    _C.MODEL.FCOS.KLLOSS_WEIGHT = 0.1

    # pseudo-labeling
    _C.SEMISUPNET.PSEUDO_BBOX_SAMPLE = "thresholding"
    _C.SEMISUPNET.BBOX_THRESHOLD = 0.5
    _C.SEMISUPNET.BBOX_CTR_THRESHOLD = 0.5
    _C.SEMISUPNET.PSEUDO_BBOX_SAMPLE_REG = "thresholding"
    _C.SEMISUPNET.BBOX_THRESHOLD_REG = 0.5
    _C.SEMISUPNET.BBOX_CTR_THRESHOLD_REG = 0.5
    _C.SEMISUPNET.ANALYSIS_PRINT_FRE = 5000
    _C.SEMISUPNET.ANALYSIS_ACCUMLATE_FRE = 200
    _C.SEMISUPNET.TS_BETTER = 0.1
    _C.SEMISUPNET.TS_BETTER_CERT = 0.8
    _C.SEMISUPNET.CONSIST_CLS_LOSS = "mse_loss_raw"
    _C.SEMISUPNET.CONSIST_CTR_LOSS = "kl_loss"
    _C.SEMISUPNET.CONSIST_REG_LOSS = "mse_loss_all_raw"
    _C.SEMISUPNET.RANDOM_FLIP_STRONG = False
    _C.SEMISUPNET.DYNAMIC_EMA = False
    _C.SEMISUPNET.DEMA_FINAL = 1.0

    _C.MODEL.ROI_BOX_HEAD.BBOX_PSEUDO_REG_LOSS_TYPE = "tsbetter"
    _C.SEMISUPNET.T_CERT = 0.5
    _C.SEMISUPNET.EMA_SCHEDULER = False
    _C.SEMISUPNET.EMA_RATE_STEP = (0.9996,)
    _C.SEMISUPNET.EMA_INTVEL = (120000,)
    _C.SEMISUPNET.EMA_KEEP_RATE = 0.0
    _C.SEMISUPNET.USE_SUP_STRONG = "both"


def add_tpu_config(cfg: CN) -> None:
    """The `TPU.*` block of the JAX package, kept key for key so that the
    shared configs/**/*.yaml load unchanged (Base-FCOS.yaml sets
    TPU.EXTRA_TRAIN_CANVASES). The fixed-shape policy keys are read by the
    port too: padded canvases, padded instance counts (MAX_GT, MAX_PSEUDO),
    the NMS candidate cap and the compute dtype. Mesh, stem-algorithm and
    host-pipeline keys have no effect in the port yet."""
    _C = cfg
    _C.TPU = CN()
    # Padded image canvas (H, W) per aspect bucket.
    _C.TPU.CANVAS_LANDSCAPE = (768, 1344)
    _C.TPU.CANVAS_PORTRAIT = (1344, 768)
    # Additional train-canvas scale buckets (list of [h, w]).
    _C.TPU.EXTRA_TRAIN_CANVASES = []
    # Eval canvas for landscape images; portrait images use the transpose.
    _C.TPU.TEST_CANVAS = (800, 1344)
    # Padded per-image instance capacities.
    _C.TPU.MAX_GT = 100            # ground-truth boxes per image
    _C.TPU.MAX_PSEUDO = 100        # pseudo boxes per image (= POST_NMS_TOPK)
    # Cap on the merged cross-level FCOS decode candidate pool; at 5000
    # (= 5 levels x PRE_NMS_TOPK 1000) the cap is a no-op. The NMS kernel
    # bounds its work by the number of valid candidates, not by this cap.
    _C.TPU.NMS_CANDIDATES = 5000
    # Compute dtype of the model ("bfloat16": bf16 autocast; "float32").
    _C.TPU.COMPUTE_DTYPE = "bfloat16"
    # Stem algorithm keys of the JAX package; the port runs the plain conv.
    _C.TPU.STEM_SPACE_TO_DEPTH = False
    _C.TPU.STEM_MODE = "conv"
    # Device mesh axis sizes; -1 means "all visible devices".
    _C.TPU.MESH_DATA = -1
    # Host data pipeline workers.
    _C.TPU.DATA_THREADS = 8
    # Eval batch size.
    _C.TPU.EVAL_BATCH = 8
    # DIAGNOSTIC: replace the teacher's pseudo labels with the unlabeled
    # stream's ground truth (batch["gt_unlabel"]) in the mutual phase, a
    # positive control for the pseudo-label consumption path.
    _C.TPU.ORACLE_PSEUDO = False


def get_cfg() -> CN:
    cfg = _detectron2_subset_defaults()
    add_tpu_config(cfg)
    return cfg
