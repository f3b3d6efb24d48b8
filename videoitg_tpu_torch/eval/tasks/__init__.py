"""Benchmark task registry — importing this package registers all tasks."""

from videoitg_tpu_torch.eval.api import register_group
from videoitg_tpu_torch.eval.tasks import (  # noqa: F401
    activitynetqa,
    ai2d,
    captioning,
    cgbench,
    chartqa,
    cinepile,
    cmmmu,
    conbench,
    cuva,
    cvrr,
    detailcaps,
    docvqa,
    egoschema,
    ferret,
    funqa,
    gqa,
    gqa_ru,
    gsm8k,
    hallusion_bench,
    iconqa,
    ifeval_task,
    ii_bench,
    illusionvqa,
    internal_eval,
    jmmmu,
    live_bench,
    llava_bench,
    llava_interleave,
    longvideobench,
    mathverse,
    mathvista,
    megabench,
    mia_bench,
    mirb,
    mix_evals,
    mlvu,
    mmbench,
    mme,
    mme_realworld,
    mmlu_pro,
    mmmu,
    mmmu_pro,
    mmsearch,
    mmstar,
    mmt,
    mmupd,
    mmvet,
    mmworld,
    moviechat,
    muirbench,
    multidocvqa,
    mvbench,
    naturalbench,
    nextqa,
    ocrbench,
    ok_vqa,
    olympiadbench,
    perceptiontest,
    pope,
    qbench,
    realworldqa,
    refcoco,
    scienceqa,
    screenspot,
    seedbench,
    seedbench_2,
    stvqa,
    synthdog,
    tempcompass,
    temporalbench,
    text_mc,
    textvqa,
    vatex,
    vcr_wiki,
    vdc,
    vibe_eval,
    video_detail_description,
    videochatgpt,
    videomme,
    vinoground,
    vitatecs,
    vizwiz_vqa,
    vl_rewardbench,
    vqav2,
    websrc,
    wildvision,
    worldqa,
    youcook2,
)

# The reference paper's headline benchmark family (README.md:61-74).
register_group("videoitg_bench", [
    "longvideobench_val_v", "mlvu", "videomme", "cgbench_subtitles",
])

# Image benchmarks (stills run through the downstream adapters as 1-frame
# videos) — validates stage-2 image-SFT checkpoints without leaving the
# framework.
register_group("image_bench",
               ["ai2d", "chartqa", "docvqa_val", "gqa", "infovqa_val",
                "mme", "mmstar", "ocrbench", "pope", "realworldqa",
                "scienceqa_img", "seedbench", "textvqa_val"])

# jmmmu.yaml groups (culture split per the per-yaml tags).
from videoitg_tpu_torch.eval.tasks.jmmmu import (  # noqa: E402
    CULTURE_AGNOSTIC as _JA,
    CULTURE_SPECIFIC as _JS,
)

register_group("jmmmu_culture_agnostic",
               [f"jmmmu_{s.lower()}" for s in _JA])
register_group("jmmmu_culture_specific",
               [f"jmmmu_{s.lower()}" for s in _JS])
register_group("jmmmu", [f"jmmmu_{s.lower()}" for s in _JA + _JS])

# mmt.yaml / mmt_mi.yaml groups.
register_group("mmt", ["mmt_val", "mmt_test"])
register_group("mmt_mi", ["mmt_mi_val", "mmt_mi_test"])

# _cmmmu.yaml group.
register_group("cmmmu", ["cmmmu_val", "cmmmu_test"])

# synthdog.yaml group.
register_group("synthdog", ["synthdog_en", "synthdog_zh"])

# multidocvqa.yaml / websrc.yaml / _screenspot.yaml groups.
register_group("multidocvqa", ["multidocvqa_val", "multidocvqa_test"])
register_group("websrc", ["websrc_val", "websrc_test"])
register_group("screenspot", ["screenspot_reg_test", "screenspot_rec_test"])

# iconqa.yaml and qbenchs_dev.yaml groups.
register_group("iconqa", ["iconqa_val", "iconqa_test"])
register_group("qbenchs_dev", ["qbench_dev", "qbench2_dev", "abench_dev"])
register_group("illusionvqa", ["illusionvqa_comprehension",
                               "illusionvqa_soft_localization"])

# RefCOCO family groups mirror the per-yaml group fields.
for _ds, _splits in (("refcoco", ("val", "testA", "testB", "test")),
                     ("refcoco+", ("val", "testA", "testB")),
                     ("refcocog", ("val", "test"))):
    register_group(f"{_ds}_bbox_rec",
                   [f"{_ds}_bbox_rec_{s}" for s in _splits])
    register_group(f"{_ds}_bbox", [f"{_ds}_bbox_{s}" for s in _splits])
    register_group(f"{_ds}_seg", [f"{_ds}_seg_{s}" for s in _splits])

# MMMU-Pro groups mirror mmmu_pro.yaml (composite dropped from the
# formal eval upstream) and mmmu_pro_cot.yaml.
register_group("mmmu_pro", ["mmmu_pro_vision", "mmmu_pro_standard"])
register_group("mmmu_pro_cot", ["mmmu_pro_vision_cot",
                                "mmmu_pro_composite_cot",
                                "mmmu_pro_standard_cot"])

# MathVerse group mirrors mathverse.yaml.
register_group("mathverse", ["mathverse_testmini",
                             "mathverse_testmini_text_only",
                             "mathverse_testmini_text_lite",
                             "mathverse_testmini_text_dominant",
                             "mathverse_testmini_vision_intensive",
                             "mathverse_testmini_vision_dominant",
                             "mathverse_testmini_vision_only"])

# MathVista groups mirror mathvista.yaml / mathvista_testmini.yaml.
register_group("mathvista_testmini", ["mathvista_testmini_cot",
                                      "mathvista_testmini_solution",
                                      "mathvista_testmini_format"])
register_group("mathvista", ["mathvista_testmini_cot",
                             "mathvista_testmini_solution",
                             "mathvista_testmini_format",
                             "mathvista_test"])

# POPE split variants mirror the reference's pope_full group
# (pope_adv/pop/random yamls).
register_group("pope_full", ["pope_adv", "pope_pop", "pope_random"])

# The VQA-accuracy family (EvalAI normalizer); vqav2 mirrors the
# reference's _vqav2.yaml group (val + test).
register_group("vqav2", ["vqav2_val", "vqav2_test"])
register_group("vqa_bench", ["textvqa_val", "vqav2_val", "ok_vqa_val2014",
                             "vizwiz_vqa_val", "gqa", "ocrbench"])

# Captioning family; coco_cap mirrors the reference's coco_cap.yaml group.
register_group("coco_cap", ["coco2014_cap_val", "coco2014_cap_test",
                            "coco2017_cap_val", "coco2017_cap_test"])
register_group("caption_bench", ["coco2014_cap_val", "coco2017_cap_val",
                                 "nocaps_val", "textcaps_val",
                                 "flickr30k_test"])

# ---------------------------------------------------------------------------
# Hub media specs (reference dataset_kwargs: dataset_path + cache_dir per
# task yaml, consumed by api/task.py:876-1010's download()). Attached
# centrally so the mapping is auditable in one place; eval/acquire.py turns
# these into extracted video caches behind --allow_download. The cache_dir
# values are byte-identical to the reference yamls so an existing lmms-eval
# $HF_HOME media cache is picked up as-is.
# ---------------------------------------------------------------------------
from videoitg_tpu_torch.eval.acquire import MediaSpec  # noqa: E402
from videoitg_tpu_torch.eval.api import TASK_REGISTRY  # noqa: E402


def _attach_media(spec: MediaSpec, *task_names: str) -> None:
    for _name in task_names:
        TASK_REGISTRY[_name].media = spec  # KeyError = typo, fail loud


_attach_media(MediaSpec("lmms-lab/Video-MME", "videomme"),
              "videomme", "videomme_w_subtitle")
_attach_media(MediaSpec("lmms-lab/egoschema", "egoschema"),
              "egoschema_subset")
_attach_media(MediaSpec("OpenGVLab/MVBench", "mvbench_video"), "mvbench")
_attach_media(MediaSpec("lmms-lab/PerceptionTest_Val", "perceptiontest_val"),
              "perceptiontest_val_mc", "perceptiontest_val_mcppl")
_attach_media(MediaSpec("lmms-lab/ActivityNetQA", "activitynetqa"),
              "activitynetqa")
_attach_media(MediaSpec("fesvhtr/CUVA_LMMs", "cuva"), "cuva_test")
_attach_media(MediaSpec("lmms-lab/CVRR-ES", "cvrr-es"),
              *[t for t in TASK_REGISTRY if t.startswith("cvrr_")])
_attach_media(MediaSpec("fesvhtr/FunQA_LMMs", "funqa"), "funqa_test")
_attach_media(MediaSpec("Enxin/lmms_MovieChat_test", "moviechat_1k_test"),
              "moviechat_global", "moviechat_breakpoint")
_attach_media(MediaSpec("lmms-lab/NExTQA", "nextqa"),
              "nextqa_mc_test", "nextqa_mc_ll")
_attach_media(MediaSpec("lmms-lab/TempCompass", "tempcompass"),
              *[t for t in TASK_REGISTRY if t.startswith("tempcompass_")])
_attach_media(MediaSpec("microsoft/TemporalBench", "temporalbench"),
              "temporalbench_short_qa", "temporalbench_long_qa")
_attach_media(MediaSpec("lmms-lab/VATEX", "vatex_test"), "vatex_test")
_attach_media(MediaSpec("wchai/lmms_VDC_test", "vdc_test"),
              *[t for t in TASK_REGISTRY if t.startswith("vdc_")])
_attach_media(MediaSpec("lmms-lab/VideoDetailDescription", "videochatgpt"),
              "video_dc499")
_attach_media(MediaSpec("lmms-lab/VideoChatGPT", "videochatgpt"),
              *[t for t in TASK_REGISTRY if t.startswith("videochatgpt_")])
_attach_media(MediaSpec("lmms-lab/worldqa", "multi-hop-reasoning"),
              "worldqa_mc", "worldqa_mc_ppl")
_attach_media(MediaSpec("lmms-lab/YouCook2", "YouCookIIVideos"),
              "youcook2_val")
_attach_media(MediaSpec("longvideobench/LongVideoBench", "longvideobench"),
              "longvideobench_val_v", "longvideobench_val_i")
_attach_media(MediaSpec("sy1998/temp", "mlvu"), "mlvu")
_attach_media(MediaSpec("sy1998/MLVU_dev", "mlvu"), "mlvu_dev")
_attach_media(MediaSpec("HanSolo9682/Vinoground", "vinoground"), "vinoground")
_attach_media(MediaSpec("MMWorld/MMWorld", "mmworld"), "mmworld")
_attach_media(MediaSpec("tomg-group-umd/cinepile", "cinepile_cache"),
              "cinepile")
_attach_media(MediaSpec("CG-Bench/CG-Bench", "cg_videos_720p"),
              "cgbench_subtitles")
_attach_media(MediaSpec("MixEval/MixEval-X", "mix_evals_video2text"),
              *[t for t in TASK_REGISTRY if t.startswith("mix_evals_")])
_attach_media(MediaSpec("lscpku/VITATECS", "vitatecs"),
              *[t for t in TASK_REGISTRY if t.startswith("vitatecs_")])

# Image benchmarks embed their visuals in the dataset rows (the reference
# splits carry PIL objects, e.g. tasks/mme/utils.py:37-38) — no blob
# archives; the spec records the hub repo (reference dataset_path) and
# embedded=True routes acquisition through the docs loader.


def _embedded(repo_id: str) -> MediaSpec:
    return MediaSpec(repo_id, "", embedded=True)


_attach_media(_embedded("lmms-lab/MME"), "mme")
_attach_media(_embedded("lmms-lab/POPE"),
              *[t for t in TASK_REGISTRY if t.startswith("pope")])
_attach_media(_embedded("lmms-lab/RealWorldQA"), "realworldqa")
_attach_media(_embedded("Lin-Chen/MMStar"), "mmstar")
_attach_media(_embedded("lmms-lab/ai2d"), "ai2d")
_attach_media(_embedded("lmms-lab/ScienceQA"), "scienceqa_img")
_attach_media(_embedded("lmms-lab/SEED-Bench"),
              "seedbench", "seedbench_ppl")
_attach_media(_embedded("lmms-lab/ChartQA"), "chartqa")
_attach_media(_embedded("lmms-lab/DocVQA"), "docvqa_val", "infovqa_val")
_attach_media(_embedded("lmms-lab/MMBench"),
              *[t for t in TASK_REGISTRY if t.startswith("mmbench_")
                and not t.startswith("mmbench_ru")])
_attach_media(_embedded("deepvk/MMBench-ru"), "mmbench_ru_dev")
_attach_media(_embedded("lmms-lab/MMMU"), "mmmu_val", "mmmu_test")
_attach_media(_embedded("lmms-lab/textvqa"), "textvqa_val", "textvqa_test")
_attach_media(_embedded("lmms-lab/GQA"), "gqa")
_attach_media(_embedded("echo840/OCRBench"), "ocrbench")
_attach_media(_embedded("lmms-lab/VQAv2"), "vqav2_val", "vqav2_test")
_attach_media(_embedded("lmms-lab/OK-VQA"), "ok_vqa_val2014")
_attach_media(_embedded("lmms-lab/VizWiz-VQA"),
              "vizwiz_vqa_val", "vizwiz_vqa_test")
_attach_media(_embedded("lmms-lab/ST-VQA"), "stvqa")
_attach_media(_embedded("lmms-lab/COCO-Caption"),
              "coco2014_cap_val", "coco2014_cap_test")
_attach_media(_embedded("lmms-lab/COCO-Caption2017"),
              "coco2017_cap_val", "coco2017_cap_test")
_attach_media(_embedded("lmms-lab/NoCaps"), "nocaps_val", "nocaps_test")
_attach_media(_embedded("lmms-lab/TextCaps"),
              "textcaps_val", "textcaps_test")
_attach_media(_embedded("lmms-lab/flickr30k"), "flickr30k_test")
_attach_media(_embedded("AI4Math/MathVista"),
              "mathvista_testmini_cot", "mathvista_testmini_solution",
              "mathvista_testmini_format", "mathvista_test")
_attach_media(_embedded("CaraJ/MathVerse-lmmseval"),
              *[t for t in TASK_REGISTRY if t.startswith("mathverse_")])
_attach_media(_embedded("lmms-lab/MMVet"), "mmvet")
_attach_media(_embedded("whyu/mm-vet-v2"), "mmvetv2", "mmvetv2_group_img")
_attach_media(_embedded("lmms-lab/HallusionBench"),
              "hallusion_bench_image", "hallusion_bench_image_intern")
_attach_media(_embedded("MMMU/MMMU_Pro"),
              *[t for t in TASK_REGISTRY if t.startswith("mmmu_pro_")])
_attach_media(_embedded("lmms-lab/RefCOCO"),
              *[t for t in TASK_REGISTRY if t.startswith("refcoco_")])
_attach_media(_embedded("lmms-lab/RefCOCOplus"),
              *[t for t in TASK_REGISTRY if t.startswith("refcoco+_")])
_attach_media(_embedded("lmms-lab/RefCOCOg"),
              *[t for t in TASK_REGISTRY if t.startswith("refcocog_")])
_attach_media(_embedded("MUIRBENCH/MUIRBENCH"), "muirbench")
_attach_media(_embedded("yifanzhang114/MME-RealWorld-Lmms-eval"),
              "mmerealworld")
_attach_media(_embedded("yifanzhang114/MME-RealWorld-CN-Lmms-eval"),
              "mmerealworld_cn")
_attach_media(_embedded("yifanzhang114/MME-RealWorld-lite-lmms-eval"),
              "mmerealworld_lite")
_attach_media(_embedded("lmms-lab/ICON-QA"), "iconqa_val", "iconqa_test")
_attach_media(_embedded("csebuetnlp/illusionVQA-Comprehension"),
              "illusionvqa_comprehension")
_attach_media(_embedded("csebuetnlp/illusionVQA-Soft-Localization"),
              "illusionvqa_soft_localization")
_attach_media(_embedded("q-future/Q-Bench-HF"), "qbench_dev")
_attach_media(_embedded("q-future/Q-Bench2-HF"), "qbench2_dev")
_attach_media(_embedded("q-future/A-Bench-HF"), "abench_dev")
_attach_media(_embedded("lmms-lab/llava-bench-in-the-wild"),
              "llava_in_the_wild")
_attach_media(_embedded("lmms-lab/llava-bench-coco"), "llava_bench_coco")
_attach_media(_embedded("lmms-lab/LLaVA-Bench-Wilder"),
              "llava_wilder_small")
_attach_media(_embedded("WildVision/wildvision-arena-data"),
              "wildvision_0617", "wildvision_0630")
_attach_media(_embedded("lmms-lab/MP-DocVQA"),
              "multidocvqa_val", "multidocvqa_test")
_attach_media(_embedded("rootsautomation/websrc"),
              "websrc_val", "websrc_test")
_attach_media(_embedded("rootsautomation/ScreenSpot"),
              "screenspot_rec_test", "screenspot_reg_test")
_attach_media(_embedded("lmms-lab/II-Bench"), "ii_bench")
_attach_media(_embedded("ConBench/ConBench_D"), "conbench")
_attach_media(_embedded("naver-clova-ix/synthdog-en"), "synthdog_en")
_attach_media(_embedded("naver-clova-ix/synthdog-zh"), "synthdog_zh")
_attach_media(_embedded("BaiqiL/NaturalBench-lmms-eval"), "naturalbench")
_attach_media(_embedded("lmms-lab/CMMMU"), "cmmmu_val", "cmmmu_test")
_attach_media(_embedded("deepvk/GQA-ru"), "gqa_ru")
_attach_media(_embedded("JMMMU/JMMMU"),
              *[t for t in TASK_REGISTRY if t.startswith("jmmmu_")])
_attach_media(_embedded("lmms-lab/MMT-Benchmark"), "mmt_val", "mmt_test")
_attach_media(_embedded("lmms-lab/MMT_MI-Benchmark"),
              "mmt_mi_val", "mmt_mi_test")
_attach_media(_embedded("RekaAI/VibeEval"), "vibe_eval")
_attach_media(_embedded("lmms-lab/SEED-Bench-2"), "seedbench_2")
_attach_media(_embedded("doolayer/SEED-Bench-2-Plus"), "seedbench_2_plus")

# --- Round-5 task families -------------------------------------------------
# Image/interleave ports: visuals embedded in the HF rows (same pattern
# as the reference's PIL-column datasets).
_attach_media(_embedded("foundation-multimodal-models/DetailCaps-4870"),
              "detailcaps")
_attach_media(_embedded("gagan3012/multilingual-llava-bench"),
              *[t for t in TASK_REGISTRY
                if t.startswith("llava_in_the_wild_")])
_attach_media(_embedded("lmms-lab/Ferret-Bench"), "ferret")
_attach_media(_embedded("lmms-lab/MIA-Bench"), "mia_bench")
_attach_media(_embedded("MMInstruction/VL-RewardBench"), "vl_rewardbench")
_attach_media(_embedded("VLLMs/MIRB-hf"), "mirb")
_attach_media(_embedded("lmms-lab/LLaVA-NeXT-Interleave-Bench"),
              "llava_interleave_bench_in_domain",
              "llava_interleave_bench_out_domain",
              "llava_interleave_bench_multi_view")
_attach_media(_embedded("lmms-lab/D170_v4.1_EN"), "d170_en")
_attach_media(_embedded("lmms-lab/D170_v4.1_CN"), "d170_cn")
_attach_media(_embedded("lmms-lab/DC100_EN"), "dc100_en")
_attach_media(_embedded("lmms-lab/DC200_CN"), "dc200_cn")
_attach_media(_embedded("lmms-lab/LiveBench"),
              "live_bench_2406", "live_bench_2407", "live_bench_2409")
_attach_media(_embedded("MM-UPD/MM-UPD"),
              *[t for t in TASK_REGISTRY
                if t.startswith(("mmaad_", "mmiasd_", "mmivqd_"))])
_attach_media(_embedded("lmms-lab/OlympiadBench"),
              "olympiadbench_test_en", "olympiadbench_test_cn")
for _lang in ("en", "zh"):
    for _diff in ("easy", "hard"):
        for _size in ("", "_100", "_500"):
            _attach_media(
                _embedded(f"vcr-org/VCR-wiki-{_lang}-{_diff}-test"
                          + _size.replace("_", "-")),
                f"vcr_wiki_{_lang}_{_diff}{_size}")
_attach_media(_embedded("CaraJ/MMSearch"),
              "mmsearch_end2end", "mmsearch_rerank",
              "mmsearch_summarization")
# MEGA-Bench ships real media blobs next to the rows; cache_dir matches
# megabench/_default_template_yaml (dataset_kwargs.cache_dir).
_attach_media(MediaSpec("TIGER-Lab/MEGA-Bench", "megabench_data"),
              "megabench_core", "megabench_open",
              "megabench_core_si", "megabench_open_si")
# Text-only suites: no visuals at all — embedded spec records the hub id.
_attach_media(_embedded("gsm8k"), "gsm8k")
_attach_media(_embedded("wis-k/instruction-following-eval"), "ifeval")
_attach_media(_embedded("hellaswag"), "hellaswag")
_attach_media(_embedded("allenai/ai2_arc"), "arc_easy", "arc_challenge")
_attach_media(_embedded("Idavidrein/gpqa"),
              "gpqa_main_zeroshot", "gpqa_diamond_zeroshot",
              "gpqa_extended_zeroshot")
_attach_media(_embedded("hails/mmlu_no_train"),
              *[t for t in TASK_REGISTRY
                if t.startswith("mmlu_") and not t.startswith("mmlu_pro_")])
_attach_media(_embedded("TIGER-Lab/MMLU-Pro"),
              *[t for t in TASK_REGISTRY if t.startswith("mmlu_pro_")])
