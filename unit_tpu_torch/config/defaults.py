"""Default configuration surface (the port's own copy of
unit_tpu/config/defaults.py: the same keys, so one YAML drives both).

Reproduces the subset of the Detectron2 default config consumed by the reference,
plus every key added by the reference repo's configs/default_config.py:4-106, plus a
``TPU`` block controlling the static-shape/bucketing decisions that replace the
reference's dynamic shapes (SURVEY.md §5 "long-context" row).  Keeping the exact key
names lets the reference's YAML files (configs/VOC, configs/COCO) drive this stack.
"""

from __future__ import annotations

from .node import CfgNode as CN


def get_cfg() -> CN:
    _C = CN()
    _C.VERSION = 2
    _C.OUTPUT_DIR = "./output"
    _C.SEED = -1
    _C.CUDNN_BENCHMARK = False

    # ---------------------------------------------------------------- MODEL
    _C.MODEL = CN()
    _C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    _C.MODEL.WEIGHTS = ""
    _C.MODEL.MASK_ON = False
    _C.MODEL.KEYPOINT_ON = False
    _C.MODEL.LOAD_PROPOSALS = False
    _C.MODEL.DEVICE = "tpu"
    # BGR means/std of the Detectron2 pretrained ResNets (caffe-style).
    _C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]

    _C.MODEL.BACKBONE = CN()
    _C.MODEL.BACKBONE.NAME = "build_resnet_backbone"
    _C.MODEL.BACKBONE.FREEZE_AT = 2
    _C.MODEL.BACKBONE.DILATED = False        # default_config.py:7
    _C.MODEL.BACKBONE.FREEZE_CONVS = 0       # default_config.py:8

    _C.MODEL.RESNETS = CN()
    _C.MODEL.RESNETS.DEPTH = 50
    _C.MODEL.RESNETS.OUT_FEATURES = ["res4"]
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = True
    _C.MODEL.RESNETS.RES5_DILATION = 1
    _C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    _C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64

    _C.MODEL.ANCHOR_GENERATOR = CN()
    _C.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    _C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    _C.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0

    _C.MODEL.PROPOSAL_GENERATOR = CN()
    _C.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"
    _C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0
    # default_config.py:27
    _C.MODEL.PROPOSAL_GENERATOR.WEAK_RPN_SCORE_TRESHOLD = 0.99

    _C.MODEL.RPN = CN()
    _C.MODEL.RPN.HEAD_NAME = "StandardRPNHead"
    _C.MODEL.RPN.IN_FEATURES = ["res4"]
    _C.MODEL.RPN.BOUNDARY_THRESH = -1
    _C.MODEL.RPN.IOU_THRESHOLDS = [0.3, 0.7]
    _C.MODEL.RPN.IOU_LABELS = [0, -1, 1]
    _C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    _C.MODEL.RPN.POSITIVE_FRACTION = 0.5
    _C.MODEL.RPN.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    _C.MODEL.RPN.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.RPN.BBOX_REG_LOSS_WEIGHT = 1.0
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
    # --- UniT additions (default_config.py:18-60) ---
    _C.MODEL.ROI_HEADS.EMBEDDING_PATH = ""
    _C.MODEL.ROI_HEADS.FINETUNE_TERMS = CN()
    _C.MODEL.ROI_HEADS.FINETUNE_TERMS.CLASSIFIER = ["lingual", "visual"]
    _C.MODEL.ROI_HEADS.FINETUNE_TERMS.BBOX = ["lingual", "visual"]
    _C.MODEL.ROI_HEADS.FINETUNE_TERMS.MASK = ["lingual", "visual"]
    _C.MODEL.ROI_HEADS.WEAK_CLASSIFIER_PROPOSAL_DIVISOR = 1
    _C.MODEL.ROI_HEADS.MULTI_BOX_HEAD = False
    _C.MODEL.ROI_HEADS.TRAIN_USING_WEAK = False
    _C.MODEL.ROI_HEADS.TRAIN_PROPOSAL_REGRESSOR = True
    _C.MODEL.ROI_HEADS.WEAK_PROPOSAL_DIVISOR = 1.0

    _C.MODEL.ROI_HEADS.FAST_RCNN = CN()
    _C.MODEL.ROI_HEADS.FAST_RCNN.NAME = "SupervisedDetectorOutputsBase"
    _C.MODEL.ROI_HEADS.FAST_RCNN.MODE = "Pre_Softmax"
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR = CN()
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.NAME = "WeakDetectorOutputsBase"
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.NUM_KMEANS_CLUSTER = 3
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.GRAPH_IOU_THRESHOLD = 0.4
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.MAX_PC_NUM = 5
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.WEAK_LOSS_MULTIPLIER = 1.0
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.OICR_ITER = 3
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.FG_THRESHOLD = 0.5
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.BG_THRESHOLD = 0.1
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.MIL_MULTIPLIER = 1.0
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.DETECTOR_TEMP = 1.0
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.CLASSIFIER_TEMP = 1.0
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.REGRESSION_BRANCH = False
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.TYPE = "OICR"
    _C.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.OICR_REGRESSION_BRANCH = False

    _C.MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD = CN()
    _C.MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.NAME = "MeanSimilarity"
    _C.MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.IN_FEATURES = ["res4"]
    _C.MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.POOLER_TYPE = "ROIAlignV2"
    _C.MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.VISUAL_SIMILARITY_THRESHOLD = 0.02
    _C.MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.SIMILARITY_COMBINATION = "Sum"
    _C.MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.TOPK = 5

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
    _C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_MASK_HEAD.NUM_CONV = 0
    _C.MODEL.ROI_MASK_HEAD.CONV_DIM = 256
    _C.MODEL.ROI_MASK_HEAD.NORM = ""
    _C.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK = False
    _C.MODEL.ROI_MASK_HEAD.POOLER_TYPE = "ROIAlignV2"

    # default_config.py:10-15
    _C.MODEL.FREEZE_LAYERS = CN()
    _C.MODEL.FREEZE_LAYERS.ROI_HEADS = []
    _C.MODEL.FREEZE_LAYERS.META_ARCH = []
    _C.MODEL.FREEZE_LAYERS.FAST_RCNN = []
    _C.MODEL.FREEZE_LAYERS.BOX_HEAD = []
    _C.MODEL.FREEZE_LAYERS.MASK_HEAD = []

    # ---------------------------------------------------------------- INPUT
    _C.INPUT = CN()
    _C.INPUT.MIN_SIZE_TRAIN = (800,)
    _C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    _C.INPUT.MAX_SIZE_TRAIN = 1333
    _C.INPUT.MIN_SIZE_TEST = 800
    _C.INPUT.MAX_SIZE_TEST = 1333
    _C.INPUT.RANDOM_FLIP = "horizontal"
    _C.INPUT.FORMAT = "BGR"
    _C.INPUT.MASK_FORMAT = "polygon"
    _C.INPUT.CROP = CN()
    _C.INPUT.CROP.ENABLED = False
    # default_config.py:72-75
    _C.INPUT.META_MIN_SIZE = 224
    _C.INPUT.META_MAX_SIZE = 480
    _C.INPUT.RESIZE_META = True
    _C.INPUT.NORMALIZE_IMAGES = False

    # ---------------------------------------------------------------- DATASETS
    _C.DATASETS = CN()
    _C.DATASETS.TRAIN = ()
    _C.DATASETS.TEST = ()
    _C.DATASETS.PROPOSAL_FILES_TRAIN = ()
    _C.DATASETS.PROPOSAL_FILES_TEST = ()
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 1000
    # default_config.py:62-94
    _C.DATASETS.META_TRAIN = ""
    _C.DATASETS.META_VAL = ""
    _C.DATASETS.META_SHOTS = []
    _C.DATASETS.META_VAL_SHOTS = 1
    _C.DATASETS.BASE_META = ""
    _C.DATASETS.BASE_META_SHOTS = 50
    _C.DATASETS.MODE = "base"
    _C.DATASETS.CLASSIFIER_DATAROOT = "datasets/VOCdevkit/"
    _C.DATASETS.CLASSIFIER_TRAIN = ()
    _C.DATASETS.ONLY_NOVEL_CLASSIFIER_DATA = False
    _C.DATASETS.FEWSHOT = CN()
    _C.DATASETS.FEWSHOT.TYPE = "VOC"
    _C.DATASETS.FEWSHOT.NUM_SHOTS = 5
    _C.DATASETS.FEWSHOT.IS_ZERO_SHOT = False
    _C.DATASETS.FEWSHOT.SPLIT_ID = 1
    _C.DATASETS.FEWSHOT.BASE_CLASSES_ID = [0, 1, 3, 4, 6, 7, 8, 10, 11, 12, 14, 15, 16, 18, 19]
    _C.DATASETS.FEWSHOT.NOVEL_CLASSES_ID = [2, 5, 9, 13, 17]
    _C.DATASETS.WEAK_CLASSIFIER_MUTLIPLIER = 1.0
    _C.DATASETS.WEAK_CLASSIFIER_SAMPLE_NUM = -1
    _C.DATASETS.NUM_SAMPLES = 120
    _C.DATASETS.BASE_MULTIPLIER = -1.0
    _C.DATASETS.NOVEL_MULTIPLER = 0.0
    _C.DATASETS.SAMPLE_MULTIPLIER = 3
    _C.DATASETS.OVER_SAMPLE = False
    _C.DATASETS.SAMPLE_WITH_REPLACEMENT = False
    _C.DATASETS.SAMPLE_SEED = 0
    _C.DATASETS.PROPOSAL_FILES_CLASSIFIER_TRAIN = ()

    # ---------------------------------------------------------------- DATALOADER
    _C.DATALOADER = CN()
    _C.DATALOADER.NUM_WORKERS = 4
    _C.DATALOADER.ASPECT_RATIO_GROUPING = True
    _C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
    _C.DATALOADER.REPEAT_THRESHOLD = 0.0
    _C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

    # ---------------------------------------------------------------- SOLVER
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
    _C.SOLVER.WEIGHT_DECAY_BIAS = 0.0001
    _C.SOLVER.CLIP_GRADIENTS = CN()
    _C.SOLVER.CLIP_GRADIENTS.ENABLED = False
    _C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
    _C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    _C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0
    # default_config.py:103-106
    _C.SOLVER.REFINEMENT_LR_FACTOR = 1.0
    _C.SOLVER.DELTA_LR_FACTOR = 1.0
    _C.SOLVER.MIL_LR_FACTOR = 1.0
    _C.SOLVER.TRAIN_ONLY_WEAK = -1

    # ---------------------------------------------------------------- TEST
    _C.TEST = CN()
    _C.TEST.EVAL_PERIOD = 0
    _C.TEST.MIN_EVAL_PERIOD = 0
    _C.TEST.DETECTIONS_PER_IMAGE = 100
    _C.TEST.EXPECTED_RESULTS = []
    _C.TEST.AUG = CN()
    _C.TEST.AUG.ENABLED = True
    _C.TEST.AUG.MIN_SIZES = (480, 576, 688, 864, 1200)
    _C.TEST.AUG.MAX_SIZE = 2000
    _C.TEST.AUG.FLIP = True
    _C.TEST.PRECISE_BN = CN()
    _C.TEST.PRECISE_BN.ENABLED = False
    _C.TEST.PRECISE_BN.NUM_ITER = 200

    # ---------------------------------------------------------------- TPU (new)
    # Static-shape / compilation-control knobs specific to the TPU rebuild.
    # These replace the reference's dynamic `ImageList` padding and per-image
    # Python loops (SURVEY.md §7.1).
    _C.TPU = CN()
    _C.TPU.MAX_GT_BOXES = 100           # padded GT instances per image
    _C.TPU.MAX_IMAGE_LABELS = 20        # padded image-level label slots (weak stream)
    _C.TPU.SIZE_DIVISIBILITY = 32       # pad image H/W up to a multiple of this
    _C.TPU.IMAGE_BUCKETS = []           # optional explicit [H, W] compile buckets
    _C.TPU.COMPUTE_DTYPE = "bfloat16"   # backbone/heads matmul+conv compute dtype
    _C.TPU.PARAM_DTYPE = "float32"
    _C.TPU.ROI_ALIGN_IMPL = "auto"      # auto | pallas | xla
    _C.TPU.NMS_IMPL = "auto"            # auto | xla
    _C.TPU.ROI_ALIGN_SAMPLING_RATIO = 2  # static sampling ratio (ref. uses adaptive)
    _C.TPU.REMAT_BACKBONE = False        # jax.checkpoint the backbone
    _C.TPU.FSDP = False                  # shard params+opt state over the data
    #                                      axis (per-layer all-gather + gradient
    #                                      reduce-scatter instead of replicate+
    #                                      all-reduce); needs >1 mesh device
    _C.TPU.TP = 1                        # tensor-parallel (model-axis) size:
    #                                      >1 makes a 2-D (data x model) mesh and
    #                                      splits big kernels' output channels
    #                                      over 'model' (GSPMD inserts the
    #                                      collectives); devices = data*TP
    _C.TPU.GRAD_ACCUM = 1                # gradient accumulation: >1 scans that
    #                                      many microbatches per optimizer step
    #                                      (one microbatch's activations live at
    #                                      a time), averaging the gradients —
    #                                      larger effective batch than fits in
    #                                      HBM; effective batch = IMS_PER_BATCH
    #                                      * GRAD_ACCUM
    _C.TPU.PP = False                    # pipeline parallelism: N-stage GPipe
    _C.TPU.PP_STAGES = 2                 # pipeline depth (>2 = ResNet-C4 block-granular
    #                                      split, balanced; max = backbone blocks + 2)
    #                                      over a (data x stage) mesh — stage 0
    #                                      runs the backbone, stage 1 the heads,
    #                                      pipelining the GRAD_ACCUM microbatches
    #                                      with a ppermute feature handoff;
    #                                      needs GRAD_ACCUM >= 2, devices = data*2
    _C.TPU.TTA_PROPOSAL_TOPK = 0         # >0: re-score only the top-K canonical
                                         # proposals per TTA variant (0 = all,
                                         # the reference protocol; head cost ~K/P)
    _C.TPU.HOST_TRANSFER_UINT8 = False   # ship TRAIN batches host->device as
                                         # uint8 (4x fewer bytes; <=0.5 LSB
                                         # image quantization vs the f32 wire).
                                         # For remote-attached chips where the
                                         # host link is the step wall.
    _C.TPU.EVAL_BATCH_SIZE = 1           # non-TTA eval batch (ref is batch-1 only,
    #                                      rcnn.py:494; our predict path is batched)
    _C.TPU.FOLD_BN_AT_EVAL = False       # fold FrozenBN into conv kernels for the
    #                                      forward-only eval pass (utils/bn_fold.py;
    #                                      off by default: the reference never folds,
    #                                      and folding reorders bf16 rounding)
    _C.TPU.DEBUG_NANS = False            # jax_debug_nans (device-side NaN traps)
    _C.TPU.PROFILE_START_STEP = 0        # >0: torch.profiler trace of the live run
    _C.TPU.PROFILE_NUM_STEPS = 3         # ... covering this many steps, written
    #                                      to OUTPUT_DIR/trace (a Chrome trace)

    # ------------------------------------------------------------- ENGINE (new)
    # The reference selects trainer classes by editing the entry script
    # (scripts import TrainerNoMeta / TrainerFineTune directly); here any
    # trainer is selectable from config/CLI, e.g.
    # ``ENGINE.TRAINER TrainerOnlyWeakFineTune``.  Empty = auto heuristic
    # (runner.trainer_class_for).
    _C.ENGINE = CN()
    _C.ENGINE.TRAINER = ""

    return _C


def add_config(cfg: CN) -> CN:
    """Kept for API parity with the reference's configs.default_config.add_config.

    All UniT keys are already part of :func:`get_cfg`; this is a no-op hook so that
    user code written against the reference (`add_config(get_cfg())`) still works.
    """
    return cfg
