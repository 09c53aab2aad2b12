"""Default config tree of the PyTorch port.

The port's own copy of ``procedurevrl_tpu/config/defaults.py``: the same
keys and defaults, so the experiment YAMLs under ``configs/**`` merge
unchanged.  The ``TPU`` group is carried for YAML compatibility; of it the
port reads only ``TPU.COMPUTE_DTYPE`` (the dtype of every product and
activation; parameters stay float32).
"""

from __future__ import annotations

from .cfg_node import CfgNode


def _build_defaults() -> CfgNode:
    _C = CfgNode()

    _C.TASK = "Classification"

    # ---- Batch norm (reference lib/config/defaults.py:14-34) ----------------
    _C.BN = CfgNode()
    _C.BN.USE_PRECISE_STATS = False
    _C.BN.NUM_BATCHES_PRECISE = 200
    _C.BN.WEIGHT_DECAY = 0.0
    _C.BN.NORM_TYPE = "batchnorm"
    _C.BN.NUM_SPLITS = 1
    # TPU extension: normalize with running stats during training and never
    # update them (the reference's misc.frozen_bn_stats as a config knob)
    _C.BN.FROZEN = False
    _C.BN.NUM_SYNC_DEVICES = 1

    # ---- ProcedureVRL-specific knobs (reference :40-65) ---------------------
    _C.DEV = CfgNode()
    _C.DEV.ENABLE = False
    _C.DEV.LOAD_DUMMY_DATA = False
    _C.DEV.CLIP_LINKING = False
    _C.DEV.CLIP_VIS_FEAT_PATH = ""
    _C.DEV.CLIP_VIS_FEAT_INPUT = False
    _C.DEV.MATCH_LANG_EMB = False
    _C.DEV.TEST_LANG_EMB = ""
    _C.DEV.TEMP = 0.02
    _C.DEV.ZERO_SHOT_ENABLED = False
    _C.DEV.ORDER_PRETRAIN_ENABLED = False
    _C.DEV.ORDER_PRETRAIN_MAX_LEN = 9
    _C.DEV.ORDER_FIX_RECOGNITION = False
    _C.DEV.ORDER_STRIDE = 2
    _C.DEV.ORDER_TFM_LAYERS = 4
    _C.DEV.ORDER_RECOG_BATCH = 9
    # dev-only override of the CLIP text tower depth (12 = the real
    # clip_vit_b_16): toy/dryrun configs shrink it so every sharded
    # compile variant doesn't pay 12 frozen text blocks of compile time
    _C.DEV.TEXT_LAYERS = 12
    _C.DEV.INPUT_NEXT_CLIP = False
    _C.DEV.EDIT_DISTANCE = 0
    _C.DEV.EPIC_USE_FRAME_LOADER = False

    # ---- Training (reference :70-134) ----------------------------------------
    _C.TRAIN = CfgNode()
    _C.TRAIN.ENABLE = True
    _C.TRAIN.DATASET = "kinetics"
    _C.TRAIN.LABEL_EMB = ""
    _C.TRAIN.FINETUNE = False
    _C.TRAIN.SEP_LR = False
    _C.TRAIN.LINEAR = False
    _C.TRAIN.EVAL = False
    _C.TRAIN.MULT = 1.0
    _C.TRAIN.TEXT = ""
    _C.TRAIN.TEXT_SAMPLE = 0
    _C.TRAIN.EPOCH_MUL = 1
    _C.TRAIN.TEXT_EMB = ""
    _C.TRAIN.TOPK = 5
    _C.TRAIN.BATCH_SIZE = 64
    _C.TRAIN.EVAL_PERIOD = 10
    _C.TRAIN.CHECKPOINT_PERIOD = 10
    _C.TRAIN.AUTO_RESUME = True
    _C.TRAIN.CHECKPOINT_FILE_PATH = ""
    _C.TRAIN.CHECKPOINT_TYPE = "pytorch"
    _C.TRAIN.CHECKPOINT_INFLATE = False
    _C.TRAIN.CHECKPOINT_EPOCH_RESET = False
    _C.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN = ()

    # ---- Testing (reference :138-165) ----------------------------------------
    _C.TEST = CfgNode()
    _C.TEST.ENABLE = True
    _C.TEST.DATASET = "kinetics"
    _C.TEST.BATCH_SIZE = 8
    _C.TEST.CHECKPOINT_FILE_PATH = ""
    _C.TEST.NUM_ENSEMBLE_VIEWS = 10
    _C.TEST.NUM_SPATIAL_CROPS = 3
    _C.TEST.CHECKPOINT_TYPE = "pytorch"
    _C.TEST.SAVE_RESULTS_PATH = ""
    _C.TEST.SAVE_PREDICT_PATH = ""
    _C.TEST.SPLIT = ""

    # ---- MViT (reference :169-281) -------------------------------------------
    _C.MVIT = CfgNode()
    _C.MVIT.MODE = "conv"
    _C.MVIT.POOL_FIRST = False
    _C.MVIT.CLS_EMBED_ON = True
    _C.MVIT.PATCH_KERNEL = [3, 7, 7]
    _C.MVIT.PATCH_STRIDE = [2, 4, 4]
    _C.MVIT.PATCH_PADDING = [2, 4, 4]
    _C.MVIT.PATCH_2D = False
    _C.MVIT.EMBED_DIM = 96
    _C.MVIT.NUM_HEADS = 1
    _C.MVIT.MLP_RATIO = 4.0
    _C.MVIT.QKV_BIAS = True
    _C.MVIT.DROPPATH_RATE = 0.1
    _C.MVIT.LAYER_SCALE_INIT_VALUE = 0.0
    _C.MVIT.DEPTH = 16
    _C.MVIT.NORM = "layernorm"
    _C.MVIT.DIM_MUL = []
    _C.MVIT.HEAD_MUL = []
    _C.MVIT.POOL_KV_STRIDE = []
    _C.MVIT.POOL_KV_STRIDE_ADAPTIVE = None
    _C.MVIT.POOL_Q_STRIDE = []
    _C.MVIT.POOL_KVQ_KERNEL = None
    _C.MVIT.ZERO_DECAY_POS_CLS = True
    _C.MVIT.NORM_STEM = False
    _C.MVIT.SEP_POS_EMBED = False
    _C.MVIT.DROPOUT_RATE = 0.0
    _C.MVIT.USE_ABS_POS = True
    _C.MVIT.REL_POS_SPATIAL = False
    _C.MVIT.REL_POS_TEMPORAL = False
    _C.MVIT.REL_POS_ZERO_INIT = False
    _C.MVIT.RESIDUAL_POOLING = False
    _C.MVIT.DIM_MUL_IN_ATT = False
    _C.MVIT.SEPARATE_QKV = False
    _C.MVIT.HEAD_INIT_SCALE = 1.0
    _C.MVIT.USE_MEAN_POOLING = False
    _C.MVIT.USE_FIXED_SINCOS_POS = False

    # ---- Model (reference :375-440) -------------------------------------------
    _C.MODEL = CfgNode()
    _C.MODEL.ARCH = "slowfast"
    _C.MODEL.MODEL_NAME = "SlowFast"
    _C.MODEL.NUM_CLASSES = 400
    _C.MODEL.LOSS_FUNC = "cross_entropy"
    _C.MODEL.SINGLE_PATHWAY_ARCH = ["c2d", "i3d", "slow", "x3d", "vit", "swin3d", "mvit"]
    _C.MODEL.MULTI_PATHWAY_ARCH = ["slowfast"]
    _C.MODEL.DROPOUT_RATE = 0.5
    _C.MODEL.DROPCONNECT_RATE = 0.0
    _C.MODEL.FC_INIT_STD = 0.01
    _C.MODEL.HEAD_ACT = "softmax"
    _C.MODEL.ACT_CHECKPOINT = False
    _C.MODEL.PRETRAINED = True
    _C.MODEL.MLP = 0
    _C.MODEL.TEXT_MODEL = ""
    _C.MODEL.TEXT_LP = False
    _C.MODEL.MAX_LEN = 64
    _C.MODEL.MIN_LEN = 0
    _C.MODEL.VIDEO_ONLY = False
    _C.MODEL.NUM_SEG = 0
    _C.MODEL.EXTRA_TR = ""
    _C.MODEL.DROP_E = 0.0
    _C.MODEL.EXTRA_POS = False
    _C.MODEL.RET_HEAD = 0
    _C.MODEL.PRE_CLASSES = 0
    _C.MODEL.HEAD_T = True
    _C.MODEL.RET_POS = False
    _C.MODEL.RET_POS_MUL = False
    _C.MODEL.DROP_PATH = 0.1

    # ---- TimeSformer (reference :462-466) -------------------------------------
    _C.TIMESFORMER = CfgNode()
    _C.TIMESFORMER.ATTENTION_TYPE = "divided_space_time"
    _C.TIMESFORMER.PRETRAINED_MODEL = ""
    _C.TIMESFORMER.DEPTH = 12

    # ---- ResNet family (reference :286-317) ------------------------------------
    _C.RESNET = CfgNode()
    _C.RESNET.TRANS_FUNC = "bottleneck_transform"
    _C.RESNET.NUM_GROUPS = 1
    _C.RESNET.WIDTH_PER_GROUP = 64
    _C.RESNET.INPLACE_RELU = True
    _C.RESNET.STRIDE_1X1 = False
    _C.RESNET.ZERO_INIT_FINAL_BN = False
    _C.RESNET.DEPTH = 50
    _C.RESNET.NUM_BLOCK_TEMP_KERNEL = [[3], [4], [6], [3]]
    _C.RESNET.SPATIAL_STRIDES = [[1], [2], [2], [2]]
    _C.RESNET.SPATIAL_DILATIONS = [[1], [1], [1], [1]]

    # ---- X3D (reference :323-348) -----------------------------------------------
    _C.X3D = CfgNode()
    _C.X3D.WIDTH_FACTOR = 1.0
    _C.X3D.DEPTH_FACTOR = 1.0
    _C.X3D.BOTTLENECK_FACTOR = 1.0
    _C.X3D.DIM_C5 = 2048
    _C.X3D.DIM_C1 = 12
    _C.X3D.SCALE_RES2 = False
    _C.X3D.BN_LIN5 = False
    _C.X3D.CHANNELWISE_3x3x3 = True

    # ---- Non-local (reference :353-374) ------------------------------------------
    _C.NONLOCAL = CfgNode()
    _C.NONLOCAL.LOCATION = [[[]], [[]], [[]], [[]]]
    _C.NONLOCAL.GROUP = [[1], [1], [1], [1]]
    _C.NONLOCAL.INSTANTIATION = "dot_product"
    _C.NONLOCAL.POOL = [
        [[1, 2, 2], [1, 2, 2]],
        [[1, 2, 2], [1, 2, 2]],
        [[1, 2, 2], [1, 2, 2]],
        [[1, 2, 2], [1, 2, 2]],
    ]

    # ---- SlowFast (reference :445-460) -------------------------------------------
    _C.SLOWFAST = CfgNode()
    _C.SLOWFAST.BETA_INV = 8
    _C.SLOWFAST.ALPHA = 8
    _C.SLOWFAST.FUSION_CONV_CHANNEL_RATIO = 2
    _C.SLOWFAST.FUSION_KERNEL_SZ = 5

    # ---- Detection (reference :694-706) ------------------------------------------
    _C.DETECTION = CfgNode()
    _C.DETECTION.ENABLE = False
    _C.DETECTION.ALIGNED = True
    _C.DETECTION.SPATIAL_SCALE_FACTOR = 16
    _C.DETECTION.ROI_XFORM_RESOLUTION = 7

    # ---- Action localization (reference :466-471) ---------------------------------
    _C.ACT_LOCALIZATION = CfgNode()
    _C.ACT_LOCALIZATION.ENABLED = False
    _C.ACT_LOCALIZATION.BETA = 1.0

    # ---- AVA dataset / eval (reference :741-812); consumed by utils/ava_eval ------
    _C.AVA = CfgNode()
    _C.AVA.FRAME_DIR = ""
    _C.AVA.FRAME_LIST_DIR = ""
    _C.AVA.ANNOTATION_DIR = ""
    _C.AVA.TRAIN_LISTS = ["train.csv"]
    _C.AVA.TEST_LISTS = ["val.csv"]
    _C.AVA.TRAIN_GT_BOX_LISTS = ["ava_train_v2.2.csv"]
    _C.AVA.TRAIN_PREDICT_BOX_LISTS = []
    _C.AVA.TEST_PREDICT_BOX_LISTS = ["ava_val_predicted_boxes.csv"]
    _C.AVA.DETECTION_SCORE_THRESH = 0.9
    _C.AVA.BGR = False
    _C.AVA.TRAIN_USE_COLOR_AUGMENTATION = False
    _C.AVA.TRAIN_PCA_JITTER_ONLY = True
    _C.AVA.TRAIN_PCA_EIGVAL = [0.225, 0.224, 0.229]
    _C.AVA.TRAIN_PCA_EIGVEC = [
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203],
    ]
    _C.AVA.TEST_FORCE_FLIP = False
    _C.AVA.FULL_TEST_ON_VAL = False
    _C.AVA.LABEL_MAP_FILE = "ava_action_list_v2.2_for_activitynet_2019.pbtxt"
    _C.AVA.EXCLUSION_FILE = "ava_val_excluded_timestamps_v2.2.csv"
    _C.AVA.GROUNDTRUTH_FILE = "ava_val_v2.2.csv"
    _C.AVA.IMG_PROC_BACKEND = "cv2"

    # ---- Demo (reference :960-1044); key-surface parity for YAML loading ----------
    _C.DEMO = CfgNode()
    _C.DEMO.ENABLE = False
    _C.DEMO.LABEL_FILE_PATH = ""
    _C.DEMO.WEBCAM = -1
    _C.DEMO.INPUT_VIDEO = ""
    _C.DEMO.DISPLAY_WIDTH = 0
    _C.DEMO.DISPLAY_HEIGHT = 0
    _C.DEMO.DETECTRON2_CFG = "COCO-Detection/faster_rcnn_R_50_FPN_3x.yaml"
    _C.DEMO.DETECTRON2_WEIGHTS = ""
    _C.DEMO.DETECTRON2_THRESH = 0.9
    _C.DEMO.BUFFER_SIZE = 0
    _C.DEMO.OUTPUT_FILE = ""
    _C.DEMO.OUTPUT_FPS = -1
    _C.DEMO.INPUT_FORMAT = "BGR"
    _C.DEMO.CLIP_VIS_SIZE = 10
    _C.DEMO.NUM_VIS_INSTANCES = 2
    _C.DEMO.PREDS_BOXES = ""
    _C.DEMO.THREAD_ENABLE = False
    _C.DEMO.NUM_CLIPS_SKIP = 0
    _C.DEMO.GT_BOXES = ""
    _C.DEMO.STARTING_SECOND = 900
    _C.DEMO.FPS = 30
    _C.DEMO.VIS_MODE = "thres"
    _C.DEMO.COMMON_CLASS_THRES = 0.7
    _C.DEMO.UNCOMMON_CLASS_THRES = 0.3
    _C.DEMO.COMMON_CLASS_NAMES = []
    _C.DEMO.SLOWMO = 1

    # ---- Mixup (reference :474-482) --------------------------------------------
    _C.MIXUP = CfgNode()
    _C.MIXUP.ENABLED = False
    _C.MIXUP.ALPHA = 0.8
    _C.MIXUP.CUTMIX_ALPHA = 1.0
    _C.MIXUP.CUTMIX_MINMAX = None
    _C.MIXUP.PROB = 1.0
    _C.MIXUP.SWITCH_PROB = 0.5
    _C.MIXUP.MODE = "batch"

    _C.EMA = CfgNode()
    _C.EMA.ENABLED = False

    # ---- Data (reference :488-560) ----------------------------------------------
    _C.DATA = CfgNode()
    _C.DATA.PATH_TO_DATA_DIR = ""
    _C.DATA.PATH_LABEL_SEPARATOR = " "
    _C.DATA.PATH_PREFIX = ""
    _C.DATA.CROP_SIZE = 224
    _C.DATA.NUM_FRAMES = 8
    _C.DATA.SAMPLING_RATE = 8
    _C.DATA.MEAN = [0.45, 0.45, 0.45]
    _C.DATA.INPUT_CHANNEL_NUM = [3, 3]
    _C.DATA.STD = [0.225, 0.225, 0.225]
    _C.DATA.TRAIN_JITTER_SCALES = [256, 320]
    _C.DATA.TRAIN_CROP_SIZE = 224
    _C.DATA.TEST_CROP_SIZE = 256
    _C.DATA.TARGET_FPS = 30
    _C.DATA.DECODING_BACKEND = "pyav"
    _C.DATA.INV_UNIFORM_SAMPLE = False
    _C.DATA.RANDOM_FLIP = True
    _C.DATA.MULTI_LABEL = False
    _C.DATA.ENSEMBLE_METHOD = "sum"
    _C.DATA.REVERSE_INPUT_CHANNEL = False
    _C.DATA.FD = 0.0
    _C.DATA.FIX_END = False
    _C.DATA.TEMPORAL_EXTENT = 8
    _C.DATA.DEIT_TRANSFORMS = False
    _C.DATA.COLOR_JITTER = 0.0
    _C.DATA.AUTO_AUGMENT = ""
    _C.DATA.RE_PROB = 0.0
    _C.DATA.USE_RAND_AUGMENT = False
    _C.DATA.USE_REPEATED_AUG = False
    _C.DATA.USE_RANDOM_RESIZE_CROPS = False
    _C.DATA.COLORJITTER = False
    _C.DATA.GRAYSCALE = False
    _C.DATA.GAUSSIAN = False
    # CLIP BPE merges file (bpe_simple_vocab_16e6.txt.gz) for ASR
    # tokenization; empty -> deterministic hash tokenizer (smoke runs).
    _C.DATA.BPE_PATH = ""

    # ---- Solver (reference :566-625) ---------------------------------------------
    _C.SOLVER = CfgNode()
    _C.SOLVER.BASE_LR = 0.1
    _C.SOLVER.LR_POLICY = "cosine"
    _C.SOLVER.COSINE_END_LR = 0.0
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEP_SIZE = 1
    _C.SOLVER.STEPS = []
    _C.SOLVER.LRS = []
    _C.SOLVER.MAX_EPOCH = 300
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.DAMPENING = 0.0
    _C.SOLVER.NESTEROV = True
    _C.SOLVER.WEIGHT_DECAY = 1e-4
    _C.SOLVER.WARMUP_FACTOR = 0.1
    _C.SOLVER.WARMUP_EPOCHS = 0.0
    _C.SOLVER.WARMUP_START_LR = 0.01
    _C.SOLVER.OPTIMIZING_METHOD = "sgd"
    _C.SOLVER.BASE_LR_SCALE_NUM_SHARDS = False

    # ---- Misc root keys (reference :629-659) ---------------------------------------
    # NUM_GPUS ranks (one process a card) on each of NUM_SHARDS hosts
    # (utils/misc.py:launch_job); TRAIN/TEST.BATCH_SIZE are per host, split
    # over its NUM_GPUS ranks (parallel/ddp.py).  1 x 1 is one process.
    _C.NUM_GPUS = 1
    _C.NUM_SHARDS = 1
    _C.SHARD_ID = 0
    _C.OUTPUT_DIR = "./tmp"
    _C.RNG_SEED = 1
    _C.LOG_PERIOD = 10
    _C.LOG_MODEL_INFO = False
    _C.DIST_BACKEND = "nccl"  # on the cards; gloo shares a card, the CPU is gloo
    _C.GLOBAL_BATCH_SIZE = 64

    # ---- Benchmark (reference :663-672) ---------------------------------------------
    _C.BENCHMARK = CfgNode()
    _C.BENCHMARK.NUM_EPOCHS = 5
    _C.BENCHMARK.LOG_PERIOD = 100
    _C.BENCHMARK.SHUFFLE = True

    # ---- Data loader (reference :678-687) ---------------------------------------------
    _C.DATA_LOADER = CfgNode()
    _C.DATA_LOADER.NUM_WORKERS = 8
    _C.DATA_LOADER.PIN_MEMORY = True
    _C.DATA_LOADER.ENABLE_MULTI_THREAD_DECODE = False

    # ---- EPIC-Kitchens (reference :709-735) ----------------------------------------------
    _C.EPICKITCHENS = CfgNode()
    _C.EPICKITCHENS.VISUAL_DATA_DIR = ""
    _C.EPICKITCHENS.ANNOTATIONS_DIR = ""
    _C.EPICKITCHENS.TRAIN_LIST = "EPIC_100_train.pkl"
    _C.EPICKITCHENS.VAL_LIST = "EPIC_100_validation.pkl"
    _C.EPICKITCHENS.TEST_LIST = "EPIC_100_validation.pkl"
    _C.EPICKITCHENS.TEST_SPLIT = "validation"
    _C.EPICKITCHENS.TRAIN_PLUS_VAL = False
    _C.EPICKITCHENS.ENABLE_ANTICIPATION = False

    # ---- Multigrid (kept so reference YAMLs load; schedule not implemented) ----
    _C.MULTIGRID = CfgNode()
    _C.MULTIGRID.EPOCH_FACTOR = 1.5
    _C.MULTIGRID.SHORT_CYCLE = False
    _C.MULTIGRID.SHORT_CYCLE_FACTORS = [0.5, 0.5 ** 0.5]
    _C.MULTIGRID.LONG_CYCLE = False
    _C.MULTIGRID.LONG_CYCLE_FACTORS = [
        (0.25, 0.5 ** 0.5),
        (0.5, 0.5 ** 0.5),
        (0.5, 1),
        (1, 1),
    ]
    _C.MULTIGRID.BN_BASE_SIZE = 8
    _C.MULTIGRID.EVAL_FREQ = 3
    _C.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = 0
    _C.MULTIGRID.DEFAULT_B = 0
    _C.MULTIGRID.DEFAULT_T = 0
    _C.MULTIGRID.DEFAULT_S = 0

    # ---- Tensorboard (reference :855-940; scalar/json logging subset) ---------
    _C.TENSORBOARD = CfgNode()
    _C.TENSORBOARD.ENABLE = False
    _C.TENSORBOARD.PREDICTIONS_PATH = ""
    _C.TENSORBOARD.LOG_DIR = ""
    _C.TENSORBOARD.CLASS_NAMES_PATH = ""
    _C.TENSORBOARD.CATEGORIES_PATH = ""
    _C.TENSORBOARD.CONFUSION_MATRIX = CfgNode()
    _C.TENSORBOARD.CONFUSION_MATRIX.ENABLE = False
    _C.TENSORBOARD.CONFUSION_MATRIX.FIGSIZE = [8, 8]
    _C.TENSORBOARD.CONFUSION_MATRIX.SUBSET_PATH = ""
    # Model visualization: weights / activations / Grad-CAM
    # (reference defaults.py:906-945)
    _C.TENSORBOARD.MODEL_VIS = CfgNode()
    _C.TENSORBOARD.MODEL_VIS.ENABLE = False
    _C.TENSORBOARD.MODEL_VIS.MODEL_WEIGHTS = False
    _C.TENSORBOARD.MODEL_VIS.ACTIVATIONS = False
    _C.TENSORBOARD.MODEL_VIS.INPUT_VIDEO = False
    _C.TENSORBOARD.MODEL_VIS.LAYER_LIST = []
    _C.TENSORBOARD.MODEL_VIS.TOPK_PREDS = 1
    _C.TENSORBOARD.MODEL_VIS.COLORMAP = "Pastel2"
    _C.TENSORBOARD.MODEL_VIS.GRAD_CAM = CfgNode()
    _C.TENSORBOARD.MODEL_VIS.GRAD_CAM.ENABLE = False
    _C.TENSORBOARD.MODEL_VIS.GRAD_CAM.LAYER_LIST = []
    _C.TENSORBOARD.MODEL_VIS.GRAD_CAM.USE_TRUE_LABEL = False
    _C.TENSORBOARD.MODEL_VIS.GRAD_CAM.COLORMAP = "viridis"
    _C.TENSORBOARD.HISTOGRAM = CfgNode()
    _C.TENSORBOARD.HISTOGRAM.ENABLE = False
    _C.TENSORBOARD.WRONG_PRED_VIS = CfgNode()
    _C.TENSORBOARD.WRONG_PRED_VIS.ENABLE = False
    _C.TENSORBOARD.WRONG_PRED_VIS.TAG = "Incorrectly classified videos."
    _C.TENSORBOARD.WRONG_PRED_VIS.SUBSET_PATH = ""
    _C.TENSORBOARD.HISTOGRAM.SUBSET_PATH = ""
    _C.TENSORBOARD.HISTOGRAM.TOPK = 10
    _C.TENSORBOARD.HISTOGRAM.FIGSIZE = [8, 8]

    # ---- TPU-native group (no reference analogue) ------------------------------
    _C.TPU = CfgNode()
    # Mesh axis sizes; -1 on DATA means "all remaining devices".
    _C.TPU.MESH_DATA = -1
    _C.TPU.MESH_MODEL = 1
    # Compute dtype for matmuls/activations ("bfloat16" or "float32").
    _C.TPU.COMPUTE_DTYPE = "bfloat16"
    # Parameter/optimizer dtype.
    _C.TPU.PARAM_DTYPE = "float32"
    # Use fused Pallas attention kernels where available.
    _C.TPU.USE_PALLAS_ATTENTION = True
    # Rematerialize encoder blocks to trade FLOPs for HBM.
    _C.TPU.REMAT = True
    # ZeRO-1: shard optimizer moments over the ranks (ZeroRedundancyOptimizer,
    # parallel/ddp.py; cuts each rank's optimizer memory ~(N-1)/N)
    _C.TPU.SHARD_OPT_STATE = False
    # keep qkv projections as remat residuals (more HBM, less recompute)
    _C.TPU.REMAT_SAVE_QKV = False
    # keep flash-attention outputs as remat residuals (False = leanest
    # footprint: full in-block recompute incl. the attention kernels)
    _C.TPU.REMAT_SAVE_ATTN = True
    # keep the temporal-attention pass output as a remat residual (the
    # pass is relayout/tiny-matmul-bound; its [B,T,N,C] output is cheap
    # to store relative to re-running it in the backward)
    _C.TPU.REMAT_SAVE_TEMPORAL = True
    # Adam moment storage dtype: "float32" (exact) or "bfloat16"
    # (stochastic-rounded, halves optimizer-state HBM; solver/low_precision)
    _C.TPU.MOMENT_DTYPE = "float32"
    # Run adam/adamw as ONE fused update over a flat [P] buffer instead of
    # the per-parameter fusion swarm (solver/flat_optimizer; the swarm
    # measured 24.7 ms/step = 20x its HBM roofline on the MViT bench step).
    # float32 moments only; parameter trajectories match the per-leaf path.
    _C.TPU.FLAT_OPT = False
    # Per-leaf SINGLE-EXPRESSION adam/adamw: one fusion per parameter
    # instead of one per optax chain stage, no flat marshalling.
    _C.TPU.FUSED_OPT = False
    # Number of host-pipeline prefetch buffers.
    _C.TPU.PREFETCH_DEPTH = 2
    # Ship uint8 frames to the device and normalize there (4x less
    # host->device traffic; normalization fuses into the stem).
    _C.TPU.HOST_UINT8 = True
    # Save checkpoints from a background thread (device-side snapshot +
    # async device->host fetch) so the save overlaps the next epoch.
    _C.TPU.ASYNC_CHECKPOINT = True
    # Profiler: capture a device trace for steps [START, START+STEPS) of
    # epoch 0 into OUTPUT_DIR/profile (view with tensorboard/xprof).
    _C.TPU.PROFILE_STEPS = 0
    _C.TPU.PROFILE_START = 10
    # jax.distributed coordinator (multi-host); empty = single host.
    _C.TPU.COORDINATOR_ADDRESS = ""
    _C.TPU.NUM_PROCESSES = 1
    _C.TPU.PROCESS_ID = 0

    return _C


_DEFAULTS = _build_defaults()


def _assert_and_infer_cfg(cfg: CfgNode) -> CfgNode:
    """Config validation (reference lib/config/defaults.py:1046-1070).

    Runs on the defaults at ``get_cfg()`` time and again on the merged
    config in ``utils/parser.load_config`` (user overrides land after the
    first call)."""
    if cfg.DETECTION.ENABLE:
        # the RoI head (models/resnet_video.py:ResNetRoIHead) and AVA
        # evaluation (utils/ava_eval.py) exist, but no shipped dataset
        # produces boxes (the reference ships none either, and its own
        # detection branch references a head class it never defines) —
        # fail fast instead of crashing on bboxes=None deep in tracing
        raise NotImplementedError(
            "DETECTION.ENABLE: no detection dataset ships with this "
            "framework; drive ResNetRoIHead directly via model.apply("
            "..., bboxes=[N,5]) — see tests/test_resnet_video_parity.py"
        )
    assert cfg.TRAIN.CHECKPOINT_TYPE in ["pytorch", "caffe2"]
    assert cfg.TRAIN.BATCH_SIZE % max(cfg.NUM_GPUS, 1) == 0
    assert cfg.TEST.CHECKPOINT_TYPE in ["pytorch", "caffe2"]
    assert cfg.TEST.BATCH_SIZE % max(cfg.NUM_GPUS, 1) == 0
    if cfg.SOLVER.BASE_LR_SCALE_NUM_SHARDS:
        cfg.SOLVER.BASE_LR *= cfg.NUM_SHARDS
    assert cfg.SHARD_ID < cfg.NUM_SHARDS
    return cfg


def get_cfg() -> CfgNode:
    """Get a validated copy of the default config (reference :1073-1077)."""
    return _assert_and_infer_cfg(_DEFAULTS.clone())
