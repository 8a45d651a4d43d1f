#!/usr/bin/env python3
"""Drive the PyTorch port's RAG-VT5 serving and training paths, its corpus
index, its BERT family, its visual paths (the DiT branch of RAG-VT5,
RAG-Pix2Struct), Hi-VT5, the VT5 family's other training forms, the
documents from local files, the layout detectors, the apps, the causal-LM
family and the multi-device layer once on one CUDA card.

    python3 chip_smoke.py            # every phase, the report and the result line
    python3 chip_smoke.py 12         # phases 1-2 and the named ones (3-14) alone, for work on them: no report

Fourteen phases; any failure raises and the script exits non-zero:

  1. a CUDA device is required; prints the card's name and power limit and
     turns TF32 off, so f32 products are full f32;
  2. builds the hand-written kernels (rag_docvqa_tpu_torch/csrc) with nvcc,
     one process per source, into build/torch_kernels/ and prints the build
     time;
  3. checks each serving kernel against its plain PyTorch version on the
     card, on a small ragged shape and at the main path's t5-base shape, in
     f32 (max abs error <= 1e-4) and bf16 (max abs error <= 2e-2 of the
     largest reference value, at least 1); the decode-attention kernel does
     f32 math on every cache dtype and is held to 1e-4 on each. Times both
     with CUDA events after a warmup. The two kernels that run on wgmma get the edges of
     their tiles in bf16: K2 (64 queries x 64 keys a tile) at T 63, 64, 65 and
     129 with dh 40 and 64, causal with GQA, Tq != Tk, a per-batch f32 bias
     with bf16 q, both mask values with a row that has no valid key, and dh
     20 (rows not 16-byte aligned: the plain-load path); the forward GEMM
     (128 x 128 or 128 x 256 tiles, K steps of 64) at 129x136x72 and
     77x135x200 for each of its eight epilogues (N 135 is odd: single-element
     stores). Each such case is launched twice and the two results must be
     equal bit for bit. The row RMSNorm (a warp a row) at d 40, 100, 768,
     1024 and 4096, 1 and 77 rows, every (x, weight) dtype pair; its
     16384 x 768 bf16 row timed also on the device, beside F.rms_norm. K3
     (split over the cache) at Te 1, 77, 513, 709 and 2048, dk 40 and 128,
     B 1, rows with one and with no valid key, a split of masked keys between
     valid ones, in f32, bf16 and int8 with f32 and bf16 queries, at each of
     its split lengths (128, 256, 512 bytes of a K2 row): f32 output within
     1e-4, the bf16 output the f32 one rounded, bit for bit, a second launch
     the same bits; then at B 32 Te 512
     (int8 and bf16) timed over 12 distinct layer caches, one per call as a
     decode step takes them (the device time beside SDPA's over the same 12
     bf16 caches), and the CUDA graph of one int8 call holding K3's own
     kernels and no other;
  4. runs the full-width f32 t5-base stack at B 8: encode through the
     kernels against the plain stack (<= 1e-4), and greedy decode with the
     decode-attention kernel on and off (identical ids, f32, bf16 and int8
     caches);
  5. serves two batches of 32 synthetic documents through
     RAGVT5Engine.inference with the configs/RAGVT5.yml values, bf16 random
     weights, an int8 cross cache and the decode-attention kernel; checks
     that every kernel of the serving path was launched and that every
     confidence is finite; counts the CUDA kernels and copies of one decode
     step in a profiler trace, K3's among them;
     b. (its own generator) each of the ten page-retrieval strategies serves
        one warmup and one counted batch of 32 through the same engine
        configuration (chunk_num 10, per_chunk_seq_len 256): the per-chunk
        strategies encode 320 rows of T 256 and the page-row ones 320 rows
        of T 512, decoding at B 320; every strategy launches K1's parts, K2
        and K3, its confidences are finite and in [0, 1] (0 is a product of
        15 near-uniform maxima that underflowed), its ms and stages are
        printed; the valid keys of the assembled rows are counted (none
        without one). Then K1 (the whole layer), K2 with the shared bias and
        K3 (12 int8 caches of Te 256 and 512, a bf16 one beside SDPA) at
        those shapes against their plain versions, timed by events and on
        the device, with K3's split per Te from one call's CUDA graph; the
        eval CLI in this process (`rag_docvqa_tpu_torch.eval`, t5-base f32,
        64 documents, maxconf, compute_stats; its summary keys); and four
        train steps with the NAC term at 6d's shapes (its 16-token decode
        through K3): the NAC loss finite and falling;
  6. the training path, outside inference mode:
     a. the flash backward (K6) against its plain version on small ragged
        shapes (shared, per-batch and no bias; causal; GQA; mask values
        -1e9 and -1e30) and at the training shape B8 H12 T512 dk64 with a
        shared bf16 bias: dq, dk, dv and dbias within 1e-4 (f32) and 2e-2
        (bf16) of max(1, max|ref|);
     b. the SASS of csrc/t5_layer_bwd.cu holds HGMMA (cuobjdump -sass of
        the built library); the backward GEMM `t5_gemm_bwd` for each of its
        (layout, epilogue) pairs at the edges of its 128 x 128 and 128 x 256
        tiles and 64-deep K steps (129x136x72, 77x264x200, the wide tile at
        8192x1280x1024, TN over 1,031 rows in 1 and 3 ranges), bf16 and f32,
        each bf16 case launched twice for equal bits; then at the path's
        shapes, timed by events and by the profiler's device time beside
        torch.matmul at the same layout (the bare product where the epilogue
        does more); the T5 layer backward halves K7 (FFN) and K8 (attention)
        against their plain versions at t5-base B8 T512 in f32 and bf16, and
        the whole-layer gradient of T5LayerTrain against autograd through the
        plain layer (f32);
     c. the full-width f32 12-layer encoder gradient at B2 T512 against
        autograd of the plain stack, within 1e-4 of each gradient's largest
        value (the rel-pos table's, which both take through bf16, within
        2e-2);
     d. eight train steps of t5-base VT5 at B 8 through make_train_step with
        the configs/RAGVT5.yml values, bf16 compute and f32 masters, on one
        repeated batch of synthetic documents (8 pages x 120 words): every
        loss and grad norm finite, the loss falls, every kernel of the
        training path launched; prints ms per step split into forward,
        backward and update. Cut: warmup 2 steps instead of 1000, so the
        learning rate is not zero;
  7. the corpus index, TF32 still off:
     a. the SASS of csrc/topk_fused.cu and csrc/topk_segmax.cu holds HGMMA
        (a bf16 index is scored on wgmma with the query in three exact bf16
        terms); the top-k kernels K4 (fused scoring + running top-k), K5 (segment
        maxima), K11 (int8) and K12 (int4) against their plain versions on
        small ragged cases (N 1536 with 1100 valid rows, D 64, B 3 and 20,
        k 5, duplicated rows that tie; no valid row; N 1024 D 32 B 40 k 48)
        and at the path's shape, N 524,288 x
        D 768, B 256 and B 8, k 10, f32 and bf16 index. Float kernels:
        values and maxima within 1e-4, and every returned index is checked
        by gathering its score from the plain score matrix (on the card
        the kernels and the flat product sum in another order, so ranks
        closer than f32 rounding may swap: index-for-index equality is not
        demanded). Integer kernels: maxima equal bit for bit, and the
        two-phase functions' indices and values equal the flat ones
        exactly. Times by CUDA events, beside torch.matmul + torch.topk on
        the same index (whose tie order is not the contract); K4 and the two
        whole functions (fused, two-phase) also at B 8, 16, 32, 64 and 256
        on both float indexes, the two sides of KERNEL_BATCH_CROSSOVER, and
        K4 and K5 at B 8 and 256 with the row-block count set by hand;
     b. ShardedIndex.build and query at that size in f32, bf16, int8, int4
        and int4 with the host rescore (k' 48, f32 host rows), as 1 and as
        4 row ranges: both give identical results; top-10 agreement with
        the plain f32 query is printed (int8 >= 0.9, refined int4 >= 0.95),
        resident bytes and queries per second at B 256 per precision;
        `refined_query_batches` over four batches equals the serial refined
        query, and both are timed;
     c. the entry point: `precompute index` on the synthetic corpus at
        t5-base width (configs/RAGVT5.yml, 256 documents of 8 pages) into a
        temporary file, then `precompute query` in every precision, with
        and without --refine; every rank line parses and the f32 ranks are
        those of single_device_query. Every kernel of the index path was
        launched in b and c;
  8. the BERT family (post-LN layer K9, its backward K10), TF32 still off:
     a. K9's parts (the GEMM's bias, bias + erf-GELU and bias + residual-in-
        f32 epilogues, the row LayerNorm at eps 1e-12 with a constant row, K2
        at dh 32 and 64 with no bias and mask value -1e30: in bf16 dh 32 runs
        in the wgmma kernel's 64-wide instantiation) and the whole
        layer against their plain versions: a small ragged case (B 7, T 24,
        d 64, one sequence with no valid key: finite) and both path shapes,
        bge-small B 1024 T 64 and XLM-R-base width B 320 T 192, f32 <= 1e-4
        and bf16 <= 2e-2 of max(1, max|ref|), with and without save_x1;
     b. the full-width f32 12-layer bge-small `bert_encode` at B 64 against
        the plain stack (<= 1e-4);
     c. path 1, embed -> index: 16,384 synthetic chunks of T 64 (some padded
        slots with no valid token) through `embed_batch("BGE")` in bf16 in
        batches of 1,024, a bf16 ShardedIndex of the embeddings, 64 embedded
        questions, k 10; embeddings finite and of unit norm, every returned
        score equal to its row's in the plain product, every K9 kernel
        launched; chunks per second;
     d. path 2, reranked serving: two batches of 32 documents through
        RAGVT5Engine.inference as in phase 5 with the cross-encoder reranker
        at XLM-R-base width (12 layers, d 768, RoBERTa positions, one label;
        320 pairs of T 192 per batch; threshold 0.4, at most 5 and at least 1
        rank); 1 to 5 valid ranks per document with scores sorted descending,
        finite confidences, every kernel of K1-K3 and K9 launched; ms per
        batch and the reranker call alone between two synchronizes;
     e. the SASS of csrc/bert_layer_bwd.cu holds HGMMA; K10's parts (the
        backward GEMM's three BERT epilogues at the tile edges of 6b and at
        the path's shapes, timed as in 6b; the weight-gradient product cut
        into row ranges, the LayerNorm backward, the column sums), `bert_ffn_bwd` and `bert_attn_bwd` at bge-small B 256
        T 64 in f32 and bf16, a sequence with no valid key (finite, equal to
        the plain version), BertLayerTrain's whole-layer gradient and the
        full-width f32 12-layer encoder gradient (B 16) against autograd of
        the plain stack, within 1e-4 of each gradient's largest value;
     f. path 3: eight contrastive steps (MultipleNegativesRankingLoss at
        scale 20, optax.adamw's constants, lr 2e-5) of the bge-small
        bi-encoder at B 256 pairs, T 64, bf16 compute on f32 masters, one
        repeated batch: loss finite and falling, every K9/K10 kernel
        launched, ms per step split into forward, backward and update by
        CUDA events; the eight losses of a second run from the same seed are
        compared digit for digit and the result printed;
  9. the visual paths (the pre-LN ViT layer K14, the query-tiled T5 layer
     K13, K1 without a bias, MaxSim K15), TF32 still off:
     a. the SASS of csrc/vit_layer.cu holds HGMMA; K14's parts (the
        LayerNorm over the compute dtype, the GEMM's bias, bias + erf-GELU and
        bias + layer-scale + residual epilogues, the attention: dh 40, 64 and
        128, a bf16 rel-pos bias with rows padded to a multiple of 8, a row
        with no valid key; in bf16 at the edges of the wgmma kernel's 64-query
        tiles and 256-key rows, T 63, 64, 65, 129, 197, 256, 257 and 300 at dh
        40, 64 and 128, with and without the bias, each launched twice for
        equal bits; the path's shape timed beside SDPA by events and by the
        profiler's device time) and the whole layer
        against their plain versions: small ragged f32 cases (plain ViT and
        BEiT with bias and layer-scale, T 197 and T 21), then ViT-base width
        B 32 T 197 in f32 (<= 1e-4) and bf16 (<= 2e-2 of max(1, max|ref|));
        then K2 and the whole K1 layer with the shared bf16 T5 bias at path
        1's encoder length, B 32 T 709 (ragged text, all visual tokens; an odd
        Tk, so the bf16 kernel reads the bias one element at a time), f32 and
        bf16, timed beside SDPA;
     b. the full-width f32 12-layer ViT-base `vit_encode` at B 8 against the
        plain stack (<= 1e-4);
     c. path 1: two batches of 32 documents through RAGVT5Engine.inference as
        in phase 5 with `use_visual`: 8 page images per document from a seed,
        the top-10 chunk boxes cropped and grid-packed on the host, the
        ViT-base tower (197 tokens) and the matcher, encoder length 709;
        finite confidences in [0, 1], every kernel of K1-K3 and K14 launched;
        ms per batch by stage, and the tower alone;
     d. K2 on the bias-free rows (no bias, scale 1, mask value -1e9; bf16:
        ragged lengths, dk 16, 32, 64 and 128, a row with no valid key; then
        B 136 T 128, B 8 T 1024 and B 8 T 2048 at H 12, each beside SDPA), K13 (small f32 and bf16
        cases against the plain version with the TPU kernel's own tiles and
        against K1's plain parts; then B 8 T 2048), K1 without a bias (B 136
        T 128 and B 8 T 1024, ragged masks, rows with no valid token; dk 40
        in bf16), K15 (one query and batched, tiles that do not divide, both
        masks, a patch set with no valid token; then B 8 and B 32 x 16 sets,
        T 128, D 768; <= 1e-4) and K3 over int8 caches of Te 709, 1024 and
        2048, each against its plain version and timed over 12 distinct
        layer caches;
     e. the full-width f32 12-layer pix2struct-base `vision_encode` at T 128
        (K1 without a bias) and T 2048 (K13) against the plain stacks, each
        layer's launches counted (K2 for the f32 attention);
     f. path 2: RAGPix2StructEngine at pix2struct-base width (vocabulary
        50,244, untied head, int8 cross cache, K3 on, bf16, f16 patches on the
        wire), chunk_num 10, 16 new tokens: 8 documents x 4 pages of 512 x 512
        from a seed through `inference` cold and with `prepare_docs` (the same
        answers), the stages of a prepared batch, K15 and the top-10 on the
        engine's own embeddings against the plain function, `inference_stream`
        over 4 batches (the per-batch answers, in order), `build_visual_index`
        + `inference_indexed` at B 32, and the 2048-patch budget at B 8, whose
        generator row runs K13; before them one bf16 `vision_encode` at T 128,
        1024 and 2048 with its launches counted; every kernel of each run
        launched, each tower's launches exactly its layers' (one K2 a layer), tokens
        decoded, confidences finite in [0, 1], pages in range;
 10. Hi-VT5 (`models/hivt5.py`, `HiVT5Engine`) at the JAX bench's Hi-VT5 row
     (t5-base, 8 page slots of 10 page tokens + 512 text tokens, B 16, 16
     new tokens; half the documents have 3-7 pages, so padded page rows with
     no valid key exist), on its own generator:
     a. the full-width f32 `encode_document` of 2 documents of 4 and 2 pages
        in 4 slots through the kernels against the plain layer (<= 1e-4,
        finite, the padded slots' rows zero); K1 (the whole layer) and K2
        at the 128 page rows of T 522 and, with the visual tokens (valid
        on the pages with a render), T 719, bf16, rows with no valid key
        (finite); K3 at B 16 over the 80-key
        document (12 int8 and 12 bf16 caches, SDPA beside the bf16 one); K14
        at B 128 renders of T 197; each against its plain version, timed by
        events and on the device;
     b. `config.build_engine` -> `HiVT5Engine.inference`, bf16, int8 cross
        cache, K3 on: a warmup and two counted batches of 16, each exactly
        24 `t5_rms_norm`, 48 `t5_gemm`, 12 `flash_fwd` and 192 K3 launches,
        confidences finite in [0, 1], every predicted page below its
        document's page count; ms per batch (encode with the page head,
        decode) and documents per second;
     c. the same with the per-page visual branch (ViT-base, 256 x 192
        renders from a seed resized on the host to 224 px; one document
        without renders, one with every second page missing): K14's launches
        as well, the host resize time, the render validity, and the
        imageless document's embedding equal to the text-only one;
     d. K6, K7 and K8 at the 128 page rows of T 522, bf16, rows with no
        valid key, each against its plain version (finite) and timed; the
        full-width f32 `forward_train` of 10a's documents, its losses and
        every gradient root through the kernels against autograd of the
        plain layer (<= 1e-4 of each gradient's largest value; the
        encoder's rel-pos table, through the bf16 bias, 2e-2); then six
        `make_hivt5_train_step` steps, bf16 compute on f32 masters, B 16 x 8
        page slots, 16-token labels, one repeated batch: K6, K7 and K8
        launched, the total loss and `ret_loss` fall; forward, backward and
        update ms by CUDA events, the peak memory;
     e. `attention_viz` on 10b's batch (page relevance sums to 1 over the
        valid pages, 0 on the padded slots); the train and eval entry points
        on configs/HiVT5_tiny.yml on the card, and the eval entry point from
        the trained checkpoint on the card and on the CPU (equal metrics).
 11. the VT5 family's training forms and documents from local files, on its
     own generator:
     a. K6, K7 and K8 against their plain versions, each timed on the device
        (K6 beside autograd through SDPA): gated (K7's dwi0 and dwi1) and
        without a bias at pix2struct-base, B 8 x 1024 patches ending in
        padding; with the shared bf16 T5 bias at t5-base, B 8, T 709 (512
        text + 197 visual tokens) and the visual key mask; K2, K6 and K3 in
        f32 at the answer-quality model's d_kv 16;
     b. the full-width f32 gradients of Pix2Struct `forward_train`
        (pix2struct-base, 2 rows of 1024 patches) and of VT5 `forward_train`
        (t5-base, ViT-base visual tokens, layout labels embedded and the
        LayoutT5 head) through the kernels against the plain layer's
        (`grad_against_plain`, as 10d);
     c. bf16 compute on f32 masters: six VT5 steps with the layout head on
        6d's batch (lr 1e-4, 10 warmup steps; the loss falls), one VT5
        forward and backward at T 709 with visual tokens from
        `visual_features`, one Pix2Struct forward and backward at B 8 x 1024
        patches (one K6 a tower layer), each timed with its peak memory;
     d. `remat` False, "layer" and True on 10d's Hi-VT5 batch and 6d's VT5
        batch, three steps each: losses and grad norms within REMAT_TOL of
        the plain step's, ms per step, peak memory;
     e. which of Pillow, `datasets`, pdfminer and pdf2image the machine has;
        an MP-DocVQA directory of 32 questions with seeded page images under a
        temporary directory; the eval entry point over it at t5-base f32 with
        in-process ingest and with two ingest workers (equal summaries);
        Hi-VT5 with the ViT-base page branch and RAG-Pix2Struct from the page
        images; `MPIngestor.ingest` with 1, 2 and 4 workers against the
        single-process ingest on phase 5's corpus, pages a second;
     f. tests/test_torch_e2e_answer_quality.py's two cases on the card (f32,
        decode through K3): ANLS 1.0 and the planted answers, Hi-VT5's page
        head on the planted page.
 12. the layout detectors, layout-guided serving, the transfer and the apps,
     on its own generator:
     a. the DiT detector (`models/layout_seg.py`) at DiT-base width, B 16
        seeded banded pages, f32 with TF32 off: its logits through K14
        against the same model through K14's plain version (`rel_tol`), the
        class maps equal above a 1e-3 top-two margin (the flips counted),
        K14's launches in one detector batch exactly 24 `vit_layer_norm`, 48
        `vit_gemm`, 12 `vit_attention`; the BEiT layer and its attention at
        B 16 T 197 in f32 and bf16 against their plain versions, timed on
        the device beside SDPA; the backbone, the head and the detector per
        page, and the head and detector with cuDNN's TF32 on;
     b. YOLO (`models/yolo.py`) at `YOLOConfig()` (width 32, 1024 px), B 4
        pages, f32: raw outputs, boxes and scores on the card against the
        port's CPU run on the same parameters; ms a page, the boxes over
        `conf_thresh` (0 with seeded weights), the drift with TF32 on;
     c. an MP-DocVQA directory of 32 questions with banded page images
        through `precompute layouts` on the card (DIT at DiT-base, YOLO at its
        defaults), pages/s; the DIT file read back by
        `use_precomputed_layouts`; the eval entry point with it (t5-base f32);
        the layout-chunked documents through `RAGVT5Engine.inference` at
        phase 5's settings (K1-K3); the words chunked with and without the
        layouts (must differ); RAG-Pix2Struct `chunk_mode: layout` through
        the eval entry point (K15) and its image chunks with and without;
     d. `device_put_batch` against `to_device` on phase 5's batch of 32:
        every field equal with its dtype, bytes and ms (median of 20, events
        and host clock), the host scan and the queued call; `evaluate` over
        64 documents copying with each (A B B A): equal answers and
        confidences;
     e. `demo --serve` on 127.0.0.1 (t5-base, its decode switched to an int8
        cross cache and K3 as phase 5 sets it): one /sample and one /ask
        over a socket, the /ask through K1-K3 with its overlay PNGs; then
        `noise_experiment` over 8 documents;
     f. K2, K6 and K3 in f32 at the answer-quality model's d_kv 16 (B 8 H 4
        T 128 with the shared bias; Te 128), timed on the device beside SDPA
        in f32 (the backward through autograd).
 13. the causal-LM family: Qwen2.5-VL-7B RAG serving, the Gemma LLM
     reranker on K2's dh-256 form, the Qwen2.5-VL tower, LoRA SFT on K2/K6
     and their CLIs (the phase's log lines say what each part checks);
 14. the multi-device layer (`parallel/mesh.py`), on its own generator:
     a. a world-size-1 NCCL process group (a FileStore rendezvous) and its
        (1, 1) (data, model) and (1,) data meshes: 7b's index (524,288 x
        768, B 256 and B 8, k 10) in f32, bf16, int8, int4 and refined int4
        built with `mesh=` against the n_shards=1 form (ids and validity
        equal, values within 1e-4, resident bytes, queries per second of
        both A B B A); sharded MaxSim at 9f's indexed shape (512 patch sets
        of 128 x 768, a 128-token query, k 10) against late_interaction and
        a stable top-k (rows equal, values within 1e-4, and the plain scores
        at them); data-parallel `evaluate` on phase 5's batch of 32 (t5-base
        bf16, int8 cross cache, K3) against the plain `evaluate` (answers and
        metrics equal; ms of both, the object gather's ms);
        `greedy_decode_sharded` at phase 5's decode (B 32, Te 512, int8
        cross cache, K3) with the split leaves as slices against
        `greedy_decode` (ids and confidences equal); the sharded VT5
        step at 6d's shapes and the Hi-VT5 step at 10d's (bf16 compute, f32
        masters, the split leaves stored as slices) against the unsharded
        step from the same weights (loss and grad norm within 1e-6 relative
        at every step; ms per step of both, in turns). The merge's
        all-gather alone, by CUDA events.
        Each group path's launches counted, its kernels required;
     b. `python -m rag_docvqa_tpu_torch.dryrun 2 --device cuda`: two ranks
        sharing the card through gloo (CUDA tensors staged through the
        host), every check of the dry run, each rank's sharded paths
        launching K1's parts, K2, K3, K4, K6-K8 and K15.

The line before the last is a JSON object with every kernel's launches in
its path's run (phase 5 for serving, 6d for training, 7b-c for the index,
8c for the BERT forward kernels, 8f for the backward ones, 9c for K14, 9f for
K15, K1 without a bias and K13; every path's counts of every kernel under
"launches_by_path", each strategy of 5b as "serve_<strategy>" and its NAC
steps as "train_nac", phase 10's paths as "hivt5_serve",
"hivt5_visual_serve" and "hivt5_train", phase 11's as "train_layout",
"train_visual", "p2s_train", "<model>_remat_<mode>", "eval_mp_docvqa_workers_<n>",
"hivt5_page_images", "p2s_page_images" and "answer_quality_<model>", phase
12's as "dit_detector", "yolo_detector", "precompute_layouts_<detector>",
"eval_layouts_vt5", "serve_layouts", "p2s_layouts", "transfer_evaluate",
"demo_ask" and "noise_experiment"; phase 14's as "group_index", "group_maxsim",
"group_evaluate", "group_decode", "group_train", "group_hivt5_train", "dryrun_rank0" and
"dryrun_rank1", and per kernel under "group_launches"),
its worst error over its own checks, and, at its path's shape, its time,
the plain version's, the time of one PyTorch call that computes the same
function where there is one ("library_ms", else null; timed here, used
nowhere in the port) and the least time the card could take ("bound_ms":
the larger of the bytes moved once over 3.35 TB/s and the operations over
the peak rate of their type, "bound_by" saying which; every timed case
under "cases"); the whole K1 layer's error
and times under "t5_layer", K7's and K8's under "t5_ffn_bwd" and
"t5_attn_bwd", the train steps under "train_step", the whole K9 layer
under "bert_layer", K10's halves under "bert_ffn_bwd" and "bert_attn_bwd",
paths 1-3 of phase 8 under "embed_index", "rerank_serve" and
"contrastive_step", the whole K14 layer under "vit_layer", the two visual
paths under "visual_serve" and "p2s_serve", phase 5b's batches, rows, K3
splits and eval summary under "strategies" and its NAC steps under
"nac_train_step", phase 10's batches, train steps, attention maps and
CLIs under "hivt5", phase 11's gradients, steps, remat runs, local-file
runs and answer quality under "train_forms", phase 12's detectors,
layout-guided runs, transfer and apps under "layouts", phase 14's under
"multichip". "t5_layer_nobias" (K1 without a
bias) and "t5_layer_qtiled" (K13) are whole layers outside the kernel list,
each with its error, its times and the launches of its parts (t5_rms_norm,
t5_gemm and flash_fwd); that each served tower ran exactly those is
asserted from the launch counts.
The last line is
{"ok": true, "device": {...}}. Weights are random, made from a seed.

Nothing here imports jax or flax, nor any module of the JAX package: the
port keeps its own copies of the plain-Python chunker (ops/chunking.py),
metrics (metrics/) and image patch math (ops/patches.py).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
F32_TOL = 1e-4
F32_TILE_TOL = 1e-5  # K4/K5 on an f32 index against the plain f32 product: six exact bf16 products
BF16_REL_TOL = 2e-2

# NVIDIA's H100 SXM data sheet, dense rates: what `bound_ms` divides by
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12

# kernel -> (source, TPU kernel it replaces, the path it runs in, the timed
# case whose times the report's "ms"/"plain_ms" give: the shape and dtype
# that path runs it at)
KERNELS = {
    "t5_rms_norm": ("rag_docvqa_tpu_torch/csrc/t5_layer.cu", "rag_docvqa_tpu/ops/fused_encoder.py:364",
                    "serve", "B32 T512 d768 bf16"),
    "t5_gemm": ("rag_docvqa_tpu_torch/csrc/t5_layer.cu", "rag_docvqa_tpu/ops/fused_encoder.py:364",
                "serve", "ffn-out 16384x768x3072 residual bf16"),
    "flash_fwd": ("rag_docvqa_tpu_torch/csrc/flash_fwd.cu", "rag_docvqa_tpu/ops/flash_attention.py:155",
                  "serve", "B32 H12 T512 dk64 shared bias bf16"),
    "decode_cross_attention": ("rag_docvqa_tpu_torch/csrc/decode_attention.cu",
                               "rag_docvqa_tpu/ops/decode_attention.py:81", "serve", "B32 H12 dk64 Te512 int8 cache"),
    "flash_bwd": ("rag_docvqa_tpu_torch/csrc/flash_bwd.cu", "rag_docvqa_tpu/ops/flash_attention.py:417",
                  "train", "B8 H12 T512 dk64 shared bias t5-mask bf16"),
    "t5_gemm_bwd": ("rag_docvqa_tpu_torch/csrc/t5_layer_bwd.cu", "rag_docvqa_tpu/ops/fused_encoder_bwd.py:102",
                    "train", "tn dWi 3072x768 over 4096 rows bf16"),
    "t5_rms_bwd": ("rag_docvqa_tpu_torch/csrc/t5_layer_bwd.cu", "rag_docvqa_tpu/ops/fused_encoder_bwd.py:243",
                   "train", "4096x768 bf16"),
    "topk_fused": ("rag_docvqa_tpu_torch/csrc/topk_fused.cu", "rag_docvqa_tpu/ops/topk.py:110",
                   "index", "N524288 D768 B8 k10 bf16"),
    "topk_segmax": ("rag_docvqa_tpu_torch/csrc/topk_segmax.cu", "rag_docvqa_tpu/ops/topk.py:200",
                    "index", "N524288 D768 B256 g8 sg16 bf16"),
    "topk_segmax_int8": ("rag_docvqa_tpu_torch/csrc/topk_segmax.cu", "rag_docvqa_tpu/ops/quant.py:68",
                         "index", "N524288 D768 B256 g16"),
    "topk_segmax_int4": ("rag_docvqa_tpu_torch/csrc/topk_segmax.cu", "rag_docvqa_tpu/ops/quant.py:246",
                         "index", "N524288 D768 B256 g16"),
    "bert_gemm": ("rag_docvqa_tpu_torch/csrc/bert_layer.cu", "rag_docvqa_tpu/ops/fused_encoder.py:67",
                  "embed", "fc1 65536x1536x384 bias_gelu bf16"),
    "bert_layer_norm": ("rag_docvqa_tpu_torch/csrc/bert_layer.cu", "rag_docvqa_tpu/ops/fused_encoder.py:67",
                        "embed", "65536x384 bf16"),
    "bert_gemm_bwd": ("rag_docvqa_tpu_torch/csrc/bert_layer_bwd.cu", "rag_docvqa_tpu/ops/fused_encoder_bwd.py:679",
                      "contrastive", "nn mul_f32 16384x1536x384 bf16"),
    "bert_ln_bwd": ("rag_docvqa_tpu_torch/csrc/bert_layer_bwd.cu", "rag_docvqa_tpu/ops/fused_encoder_bwd.py:679",
                    "contrastive", "16384x384 bf16"),
    "bert_col_sum": ("rag_docvqa_tpu_torch/csrc/bert_layer_bwd.cu", "rag_docvqa_tpu/ops/fused_encoder_bwd.py:800",
                     "contrastive", "16384x1536 f32"),
    "vit_layer_norm": ("rag_docvqa_tpu_torch/csrc/vit_layer.cu", "rag_docvqa_tpu/ops/fused_encoder.py:1031",
                       "serve_visual", "6304x768 bf16"),
    "vit_gemm": ("rag_docvqa_tpu_torch/csrc/vit_layer.cu", "rag_docvqa_tpu/ops/fused_encoder.py:1031",
                 "serve_visual", "fc2 6304x768x3072 bias_scale_residual bf16"),
    "vit_attention": ("rag_docvqa_tpu_torch/csrc/vit_layer.cu", "rag_docvqa_tpu/ops/fused_encoder.py:1031",
                      "serve_visual", "B32 H12 T197 dh64 bias bf16"),
    "maxsim": ("rag_docvqa_tpu_torch/csrc/maxsim.cu", "rag_docvqa_tpu/ops/late_interaction.py:56",
               "p2s", "B8 mc16 Tq128 Tp128 D768 f32"),
    # K2's 256-wide form (its launches are also counted under flash_fwd): the Gemma LLM reranker's attention
    "flash_fwd_dh256": ("rag_docvqa_tpu_torch/csrc/flash_fwd.cu", "rag_docvqa_tpu/ops/flash_attention.py:277",
                        "llm_rerank_serve", "Gemma reranker B320 H8 Hkv1 T192 dh256 causal ragged bf16"),
    # the causal LM's glue between its GEMMs (ops/lm_glue.py): no TPU kernel, XLA fuses it in the JAX package
    "lm_add_rms_norm": ("rag_docvqa_tpu_torch/csrc/lm_glue.cu", "none (XLA fusion)", "qwen_serve",
                        "Qwen2.5-VL-7B prefill 73728x3584 residual bf16"),
    "lm_bias_rope": ("rag_docvqa_tpu_torch/csrc/lm_glue.cu", "none (XLA fusion)", "qwen_serve",
                     "Qwen2.5-VL-7B prefill B32 T2304 H28 Hkv4 hd128 M-RoPE biases bf16"),
    "lm_glu": ("rag_docvqa_tpu_torch/csrc/lm_glue.cu", "none (XLA fusion)", "qwen_serve",
               "Qwen2.5-VL-7B prefill 73728x18944 SwiGLU bf16"),
}
# the kernels each path launches
SERVE_KERNELS = ("t5_rms_norm", "t5_gemm", "flash_fwd", "decode_cross_attention")
TRAIN_KERNELS = ("t5_rms_norm", "t5_gemm", "flash_fwd", "flash_bwd", "t5_gemm_bwd", "t5_rms_bwd")
INDEX_KERNELS = ("topk_fused", "topk_segmax", "topk_segmax_int8", "topk_segmax_int4")
EMBED_KERNELS = ("bert_gemm", "bert_layer_norm", "flash_fwd")  # K9
CONTRASTIVE_KERNELS = EMBED_KERNELS + ("flash_bwd", "t5_gemm_bwd", "bert_gemm_bwd", "bert_ln_bwd", "bert_col_sum")  # + K10


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(fn, iters: int) -> dict:
    """Device time of each CUDA kernel (and copy) of one call of `fn`, by
    name, in microseconds, from a torch.profiler trace of `iters` calls: the
    names tell which kernels a library call ran. A trace on the H100 can miss
    events (from a few to over half of them seen), so these are no sum to
    time a call by: `device_ms` does that."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.events():
        if e.device_type == cuda:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return {n: sum(t) / len(t) * max(1, round(len(t) / iters)) for n, t in by_name.items()}


def graph_nodes(fn) -> list:
    """The device work one call of `fn` enqueues, one entry a node of the CUDA
    graph captured from it (a kernel by its name, a copy or memset by its
    kind), from the graph's DOT dump. Unlike a profiler trace, which on the
    H100 can miss events, the capture holds every launch."""
    import tempfile

    fn()  # warm up on a side stream, as a capture asks
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        path = os.path.join(tmp, "graph.dot")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the dump's own "DEBUG: calling ..." notes
            graph.debug_dump(path)
        if not os.path.exists(path):
            raise AssertionError("graph_nodes: the CUDA graph's DOT dump was not written")
        with open(path) as f:
            dot = f.read()
    starts = [m.start() for m in re.finditer(r'^\s*"?graph_\d+_node_\d+"?\s*\[', dot, re.M)]
    if not starts:
        raise AssertionError(f"graph_nodes: no node found in the CUDA graph's DOT dump: {dot[:2000]!r}")
    names = []
    for a, b in zip(starts, starts[1:] + [len(dot)]):
        node = dot[a:b]
        kind = re.search(r'label="\{?\s*(\w+)', node)
        kernel = re.search(r"\w*[Kk]ernel\w*(?:<[^(\\|]*>)?", node)
        names.append(" ".join(x for x in (kind and kind.group(1), kernel and kernel.group(0)) if x) or node[:200])
    return names


@functools.lru_cache(maxsize=1)
def sleep_cycles_per_ms() -> float:
    """The rate of torch.cuda._sleep, the card's spin kernel, in cycles a ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of `fn`: CUDA events around `iters` back-to-back
    calls queued behind a spin kernel that holds the card until the host has
    launched them all, so the time between the events is the card's work and
    the launch gaps of a full queue, free of the host's time per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3  # one call, host and device: more than its host time alone
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * iters * host_ms + 1.0, 500.0) * sleep_cycles_per_ms()))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    # a call that waits for the card itself would count the spin: the plain events bound it
    return min(start.elapsed_time(end) / iters, time_ms(fn, iters, warmup=0))


def nbytes(*tensors) -> int:
    """Bytes of the given tensors, each counted once (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(io_bytes: float, ops: float, op_type: str):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the operations over its peak rate for their type."""
    by_bytes, by_ops = io_bytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def op_type(dtype: torch.dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8"}[dtype]


def tol(dtype: torch.dtype, want: torch.Tensor) -> float:
    """The limit on max abs error: F32_TOL for f32 math, BF16_REL_TOL of the
    largest reference value (at least 1) for bf16."""
    if dtype == torch.float32:
        return F32_TOL
    return BF16_REL_TOL * max(want.float().abs().max().item(), 1.0)


def rel_tol(dtype: torch.dtype, want: torch.Tensor) -> float:
    """F32_TOL (f32) or BF16_REL_TOL (bf16) times max(1, max|ref|): the
    training checks, whose gradients sum over thousands of rows."""
    return (F32_TOL if dtype == torch.float32 else BF16_REL_TOL) * max(want.float().abs().max().item(), 1.0)


class PartsBound:
    """The sum of the bounds of the kernels one call of a composed layer
    launches (K1, K7-K10: `fe._t5_layer`, `fe._ffn_bwd` and the like take
    each kernel wrapper as a parameter): `wrap(fn)` gives the wrapper back
    adding its own call's bound to `ms`, its tensors (arguments and results,
    each once) over the memory rate and its operations, counted as the
    per-kernel rows count them, over their type's peak rate."""

    def __init__(self):
        self.ms = 0.0

    def wrap(self, fn):
        from rag_docvqa_tpu_torch.ops import flash_attention as fa
        from rag_docvqa_tpu_torch.ops import fused_encoder as fe

        def mnk(a, b, layout):
            M, K = (a.shape[1], a.shape[0]) if layout == "tn" else a.shape
            return M, (b.shape[0] if layout == "nt" else b.shape[1]), K

        def attention(q, k, *_, **__):  # q (B, Tq, H, dh), k (B, Tk, Hkv, dh): one product of the attention
            return 2.0 * q.shape[0] * q.shape[2] * q.shape[1] * k.shape[1] * q.shape[3]

        ops = {fe.gemm: lambda a, w, *_, **__: 2.0 * a.shape[0] * w.shape[0] * a.shape[1],
               fe.gemm_bwd: lambda a, b, layout, *_, **__: 2.0 * math.prod(mnk(a, b, layout)),
               fa.flash_attention_fwd: lambda *a, **k: 2 * attention(*a, **k),
               fa.flash_attention_bwd: lambda *a, **k: 5 * attention(*a, **k),
               fe.rms_norm_rows: lambda x, *_: 4.0 * x.numel(), fe.rms_norm_bwd: lambda x, *_: 10.0 * x.numel(),
               fe.layer_norm_rows: lambda y, *_: 8.0 * y.numel(), fe.layer_norm_bwd: lambda y, *_: 16.0 * y.numel(),
               fe.col_sum: lambda x: 1.0 * x.numel()}[fn]
        products = (fe.gemm, fe.gemm_bwd, fa.flash_attention_fwd, fa.flash_attention_bwd)

        def call(*args, **kw):
            out = fn(*args, **kw)
            tensors = {}
            for t in (*args, *kw.values(), *(out if isinstance(out, tuple) else (out,))):
                for x in (t if isinstance(t, tuple) else (t,)):
                    if isinstance(x, torch.Tensor):
                        tensors[id(x)] = x
            first = next(iter(tensors.values()))
            self.ms += bound(nbytes(*tensors.values()), ops(*args, **kw),
                             op_type(first.dtype) if fn in products else "f32")[0]
            return out

        return call


def check_launched(launches: dict, names, path: str) -> None:
    missing = [k for k in names if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels of the {path} path never launched: {missing}")


@functools.lru_cache(maxsize=1)
def sass_counts() -> dict:
    """Per kernel function of the built library (`cuobjdump -sass`), its
    tensor-core product instructions by mnemonic (HGMMA: bf16 wgmma; IGMMA:
    s8 wgmma; any other *GMMA as it is printed) and its IDP.4A (__dp4a)."""
    from rag_docvqa_tpu_torch import kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(kernels.build())], capture_output=True, text=True, timeout=600)
    if sass.returncode != 0:
        raise AssertionError(f"cuobjdump -sass failed ({sass.returncode}): {sass.stderr[-2000:]}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts.setdefault(fn, {})
        elif fn is not None:
            for op in re.findall(r"\b([A-Z]+GMMA|IDP\.4A)\b", line):
                counts[fn][op] = counts[fn].get(op, 0) + 1
    return counts


def check_hgmma(source: str, need=(), forbid=()) -> None:
    """Fails unless the built SASS of csrc/<source>.cu holds wgmma products,
    every instantiation of each kernel named in `need` ((kernel name,
    mnemonic) pairs) holds that mnemonic, and none of each kernel named in
    `forbid` does."""
    stem = source.removesuffix(".cu")
    mine = {fn: ops for fn, ops in sass_counts().items() if f"_{stem}_cu_" in fn}
    gmma = {fn: sum(n for op, n in ops.items() if op.endswith("GMMA")) for fn, ops in mine.items()}
    log(f"  SASS of csrc/{source}: {sum(gmma.values())} wgmma instructions in {sum(1 for n in gmma.values() if n)} of "
        f"its {len(mine)} kernels")
    if sum(gmma.values()) == 0:
        raise AssertionError(f"csrc/{source}: no wgmma (*GMMA) in the built SASS; its kernels are not on wgmma")
    for name in dict.fromkeys(n for n, _ in (*need, *forbid)):
        fns = {fn: ops for fn, ops in mine.items() if name in fn}
        if not fns:
            raise AssertionError(f"csrc/{source}: no kernel {name} in the built SASS")
        for fn, ops in fns.items():
            tq = re.search(r"ILi(\d+)E", fn)  # the mangled template argument, the query tile
            log(f"    {name}<{tq.group(1) if tq else ''}>: {dict(sorted(ops.items()))}")
            for op in (op for n, op in need if n == name):
                if ops.get(op, 0) == 0:
                    raise AssertionError(f"csrc/{source}: {fn} holds no {op}")
            for op in (op for n, op in forbid if n == name):
                if ops.get(op, 0) != 0:
                    raise AssertionError(f"csrc/{source}: {fn} holds {ops[op]} {op}, which it must not")


class Checks:
    """Worst error per checked unit (each kernel, and `t5_layer`, the whole
    layer K1 composes from three of them) and every timed case."""

    def __init__(self):
        self.err = {}
        self.times = {}  # unit -> {case label: {"ms", "plain_ms", "library_ms", "bound_ms", "bound_by"}}

    def compare(self, unit: str, label: str, got: torch.Tensor, want: torch.Tensor, limit: float) -> float:
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"{unit} {label}: non-finite values")
        err = (got - want).abs().max().item()
        log(f"  {unit:24s} {label:44s} max_abs_err {err:.3e}  (limit {limit:.1e}, max|ref| {want.abs().max().item():.3g})")
        if not err <= limit:
            raise AssertionError(f"{unit} {label}: max abs error {err} above {limit}")
        self.err[unit] = max(self.err.get(unit, 0.0), err)
        return err

    def timed(self, unit: str, label: str, fn, plain, iters: int = 10, library=None, io_bytes=None, ops=0.0,
              ops_in: str = "f32", library_is: str = "", device: bool = False, parts_bound=None) -> None:
        """Times `fn` against `plain` and, when given, against `library`
        (one PyTorch call for the same function, or for what `library_is`
        says it computes where no one call does the whole function), all by
        CUDA events around back-to-back calls; `device` adds the device time
        of `fn` and `library` alone (`device_ms`), where a fast kernel's
        wrapper takes longer on the host than the kernel on the card.
        `io_bytes` (every input read once, every output written once) and
        `ops` of type `ops_in` give the bound; a composed layer gives the sum
        of its parts' bounds instead (`parts_bound`, a PartsBound)."""
        row = {"ms": time_ms(fn, iters), "plain_ms": time_ms(plain, iters),
               "library_ms": None if library is None else time_ms(library, iters)}
        text = f"kernel {row['ms']:.4f} ms   plain {row['plain_ms']:.4f} ms"
        if device:
            row["device_ms"] = device_ms(fn, iters)
            text += f"   kernel on the device {row['device_ms']:.4f} ms"
            parts = sorted(kernel_times(fn, iters).items(), key=lambda x: -x[1])
            name = lambda n: (re.search(r"\w+_kernel(<[^>]*>)?", n) or re.search(r".{1,60}", n)).group(0)
            log(f"  {unit} {label}: its kernels by name (profiler): "
                + "; ".join(f"{name(n)} {t:.1f} us" for n, t in parts[:6]))
            if library is not None:
                row["library_device_ms"] = device_ms(library, iters)
                text += f" (library {row['library_device_ms']:.4f} ms)"
        if library is not None:
            text += f"   library {row['library_ms']:.4f} ms" + (f" ({library_is})" if library_is else "")
            if library_is:
                row["library_is"] = library_is
        if io_bytes is not None:
            row["bound_ms"], row["bound_by"] = bound(io_bytes, ops, ops_in)
        if parts_bound is not None:
            row["bound_ms"], row["bound_by"] = parts_bound.ms, "sum of its parts' bounds"
        if "bound_ms" in row:
            text += f"   bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
        self.times.setdefault(unit, {})[label] = row
        log(f"  {unit:24s} {label:44s} {text}")


# --------------------------------------------------------------------------- #
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------- #
def key_mask(lens, Tk: int, dev) -> torch.Tensor:
    """(B, Tk) bool: `lens` itself when it is a mask, else each row's first
    lens[b] keys."""
    if isinstance(lens, torch.Tensor) and lens.dtype == torch.bool:
        return lens
    return torch.arange(Tk, device=dev)[None, :] < torch.as_tensor(lens, device=dev)[:, None]


def flash_case(checks: Checks, g: torch.Generator, B, T, H, Hkv, dh, dtype, bias_kind, causal, scale, mask_value,
               lens, label, timed=False, Tk=None, twice=False, device=False):
    """K2 against its plain version: out, lse of the rows with a valid key,
    the lse contract of the others; `twice` launches again and wants the
    same bits. T queries, Tk keys (T when None); `lens` each row's count of
    valid keys (a prefix), or the (B, Tk) bool key mask; bias_kind None, "shared",
    "batched" (in q's dtype; bf16 for bf16) or "batched f32"; `device` adds
    the device times of the kernel and of SDPA to a timed case."""
    import torch.nn.functional as F

    from rag_docvqa_tpu_torch.ops import flash_attention as fa

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    Tk = T if Tk is None else Tk
    q = randn(B, T, H, dh).to(dtype)
    k, v = randn(B, Tk, Hkv, dh).to(dtype), randn(B, Tk, Hkv, dh).to(dtype)
    mask = key_mask(lens, Tk, dev)
    bias = None
    if bias_kind:
        bias = randn(1 if bias_kind == "shared" else B, H, T, Tk)
        if dtype == torch.bfloat16 and bias_kind != "batched f32":
            bias = bias.bfloat16()
    run = lambda: fa.flash_attention_fwd(q, k, v, mask, bias, scale, causal, mask_value)
    got, glse = run()
    want, wlse = fa.flash_attention_reference(q, k, v, mask, bias, scale, causal, mask_value)
    checks.compare("flash_fwd", f"{label} out", got, want, tol(dtype, want))
    alive = wlse > mask_value / 2  # rows with a valid key; the out check covers the rest
    # lse is f32 in both; its bf16 limit scales with the bf16 inputs' scores
    checks.compare("flash_fwd", f"{label} lse", glse[alive], wlse[alive], tol(dtype, wlse[alive]))
    dead = glse[~alive]  # no valid key: -1e30 under the flash mask value, the uniform row's lse under -1e9
    if not bool((dead <= mask_value / 2).all() if mask_value == fa.NEG_INF else torch.isfinite(dead).all()):
        raise AssertionError(f"flash_fwd {label}: lse of a row with no valid key is {dead.max().item()}")
    if twice:
        again, alse = run()
        if not (torch.equal(got, again) and torch.equal(glse, alse)):
            raise AssertionError(f"flash_fwd {label}: a second launch on the same input gave other bits")
    if timed:
        # the one library call: SDPA with the bias and the key mask summed
        # into one additive (B, H, T, T) mask beforehand (the kernel
        # streams the shared bias instead); it returns no lse
        add = (bias.float() + torch.where(mask, 0.0, mask_value)[:, None, None, :]).to(dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        checks.timed("flash_fwd", label, run,
                     lambda: fa.flash_attention_reference(q, k, v, mask, bias, scale, causal, mask_value),
                     library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add, scale=scale),
                     io_bytes=nbytes(q, k, v, mask, bias, got, glse), ops=4.0 * B * H * T * T * dh,
                     ops_in=op_type(dtype), device=device)


def check_kernels(checks: Checks, g: torch.Generator) -> None:
    import torch.nn.functional as F

    from rag_docvqa_tpu_torch.models.layers import rms_norm
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)

    # ---- K2 flash attention ----
    # bf16, on the edges of the tensor-core kernel's 64 x 64 tiles
    bf16, t5_mask = torch.bfloat16, fe.T5_MASK_VALUE
    for T in (63, 64, 65, 129):
        for dh in (40, 64):
            flash_case(checks, g, 3, T, 4, 4, dh, bf16, "shared", False, dh ** -0.5, t5_mask, [T, T // 2, 1],
                       f"edge T{T} dh{dh} shared bias bf16", twice=True)
    flash_case(checks, g, 3, 129, 8, 2, 64, bf16, None, True, 0.125, fa.NEG_INF, [129, 70, 0], "edge T129 causal gqa bf16", twice=True)
    flash_case(checks, g, 3, 65, 4, 4, 64, bf16, "batched f32", False, 0.125, fa.NEG_INF, [129, 64, 5],
               "edge Tq65 Tk129 f32 batched bias bf16", Tk=129, twice=True)
    flash_case(checks, g, 2, 129, 4, 2, 40, bf16, "shared", True, 40 ** -0.5, fa.NEG_INF, [65, 33],
               "edge Tq129 Tk65 causal gqa dh40 bf16", Tk=65, twice=True)
    flash_case(checks, g, 2, 64, 4, 4, 64, bf16, "shared", False, 0.125, fa.NEG_INF, [64, 0], "edge no valid key -1e30 bf16", twice=True)
    flash_case(checks, g, 2, 65, 4, 4, 64, bf16, "shared", False, 0.125, t5_mask, [65, 0], "edge no valid key -1e9 bf16", twice=True)
    flash_case(checks, g, 2, 65, 4, 4, 20, bf16, "shared", False, 20 ** -0.5, fa.NEG_INF, [65, 40],
               "edge dh20 (rows not 16-byte aligned) bf16", twice=True)

    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        flash_case(checks, g, 3, 77, 4, 2, 40, dtype, "batched", True, 0.5, fa.NEG_INF, [77, 50, 0], f"ragged gqa causal {tag}")
        flash_case(checks, g, 3, 77, 4, 4, 128, dtype, "shared", False, 1.0, fe.T5_MASK_VALUE, [77, 30, 0], f"ragged dh128 t5-mask {tag}")
        flash_case(checks, g, 32, 512, 12, 12, 64, dtype, "shared", False, 1.0, fe.T5_MASK_VALUE,
                   [512 - 13 * i for i in range(32)], f"B32 H12 T512 dk64 shared bias {tag}", timed=dtype == torch.bfloat16)

    # ---- K1 parts and the whole layer ----
    cfg = t5m.T5Config()
    d, inner, dff = cfg.d_model, cfg.inner_dim, cfg.d_ff
    # the row RMSNorm (a warp a row): widths in its register buckets (768, 1024,
    # 4096), one that is no multiple of the 16-byte vector in bf16 (40 is one
    # in both dtypes, 100 only in f32), 1 and 77 rows, every (x, weight) pair
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for w_dtype, wtag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            for width in (40, 100, 768, 1024, 4096):
                for M in (1, 77):
                    x = (randn(M, width) * 3.0).to(dtype)
                    w = (torch.rand(width, generator=g, device=dev) + 0.5).to(w_dtype)
                    got, want = fe.rms_norm_rows(x, w, cfg.layer_norm_eps), rms_norm(x, w, cfg.layer_norm_eps)
                    checks.compare("t5_rms_norm", f"{M}x{width} x {tag} w {wtag}", got, want, tol(dtype, want))
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for M, label in ((77, "ragged"), (32 * 512, "B32 T512")):
            x = randn(M, d).to(dtype)
            w = (torch.rand(d, generator=g, device=dev) + 0.5).to(dtype)
            got, want = fe.rms_norm_rows(x, w, cfg.layer_norm_eps), rms_norm(x, w, cfg.layer_norm_eps)
            checks.compare("t5_rms_norm", f"{label} d768 {tag}", got, want, tol(dtype, want))
            if M > 77 and dtype == torch.bfloat16:
                checks.timed("t5_rms_norm", f"{label} d768 {tag}", lambda: fe.rms_norm_rows(x, w, 1e-6),
                             lambda: rms_norm(x, w, 1e-6), library=lambda: F.rms_norm(x, (d,), w, 1e-6),
                             io_bytes=nbytes(x, w, got), ops=4.0 * M * d, device=True)
        for (M, N, K, epi), label in (((77, 100, 72, "relu"), "ragged 77x100x72 relu"),
                                      ((77, 96, 64, "gelu_mul"), "ragged 77x96x64 gelu_mul"),
                                      ((16384, 3 * inner, d, "none"), "qkv 16384x2304x768"),
                                      ((16384, dff, d, "relu"), "ffn-in 16384x3072x768 relu"),
                                      ((16384, d, dff, "residual"), "ffn-out 16384x768x3072 residual")):
            a = randn(M, K).to(dtype)
            w = (randn(N, K) * K**-0.5).to(dtype)
            aux = randn(M, N).to(dtype) if epi in ("residual", "gelu_mul") else None
            got, want = fe.gemm(a, w, epi, aux), fe.gemm_reference(a, w, epi, aux)
            checks.compare("t5_gemm", f"{label} {tag}", got, want, tol(dtype, want))
            if M == 16384 and dtype == torch.bfloat16:
                library = {"none": lambda: torch.matmul(a, w.t()),
                           "residual": lambda: torch.addmm(aux, a, w.t())}.get(epi)  # relu: no single call
                checks.timed("t5_gemm", f"{label} {tag}", lambda: fe.gemm(a, w, epi, aux),
                             lambda: fe.gemm_reference(a, w, epi, aux), library=library,
                             io_bytes=nbytes(a, w, aux, got), ops=2.0 * M * N * K, ops_in=op_type(dtype),
                             device=True)

    # the bf16 GEMM's tails in M, N and K (K 72 is one full step of 64 and one of
    # 8; N 135 is odd, so the epilogue stores single elements), every epilogue,
    # and a second launch's bits
    for M, N, K in ((129, 136, 72), (77, 135, 200)):
        for epi in fe.EPILOGUES:
            a, w = randn(M, K).bfloat16(), (randn(N, K) * K**-0.5).bfloat16()
            aux = randn(M, N).bfloat16() if epi in ("residual", "gelu_mul", "bias_residual_f32", "bias_scale_residual") else None
            b = randn(N).bfloat16() if epi.startswith("bias") else None
            sc = randn(N).bfloat16() if epi == "bias_scale_residual" else None
            run = (lambda: fe.vit_gemm(a, w, epi, aux, b, sc)) if epi == "bias_scale_residual" else (lambda: fe.gemm(a, w, epi, aux, b))
            got, want = run(), fe.gemm_reference(a, w, epi, aux, b, sc)
            unit = "vit_gemm" if epi == "bias_scale_residual" else ("bert_gemm" if epi.startswith("bias") else "t5_gemm")
            if got.dtype != want.dtype:
                raise AssertionError(f"{unit} {epi}: output is {got.dtype}, the plain version's {want.dtype}")
            checks.compare(unit, f"tails {M}x{N}x{K} {epi} bf16", got, want, tol(torch.bfloat16, want))
            if not torch.equal(got, run()):
                raise AssertionError(f"{unit} {epi} {M}x{N}x{K}: a second launch on the same input gave other bits")

    params = t5m.init_t5_params(g, t5m.T5Config(num_encoder_layers=1, num_decoder_layers=1))
    layer = fe.fuse_t5_blocks(params.encoder.layers, False)[0]
    pos = torch.arange(512)
    bias = t5m.relative_bias(params.encoder.rel_bias, pos, pos, True, cfg)[0].to(torch.bfloat16).contiguous()
    lens = torch.tensor([512 - 13 * i for i in range(32)], device=dev)
    mask = torch.arange(512, device=dev)[None, :] < lens[:, None]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        l = {k: v.to(dtype) for k, v in layer.items()}
        x = randn(32, 512, d).to(dtype)
        kw = dict(num_heads=cfg.num_heads, eps=cfg.layer_norm_eps, gated=False)
        got = fe.fused_t5_layer_parts(x, mask, bias, l, **kw)
        want = fe.t5_layer_reference(x, mask, bias, l, **kw)
        # K1 = rms_norm + gemm + flash_fwd, against the plain layer
        checks.compare("t5_layer", f"B32 T512 t5-base {tag}", got, want, tol(dtype, want))
        if dtype == torch.bfloat16:
            pb = PartsBound()
            fe._t5_layer(x, mask, bias, l, cfg.num_heads, cfg.layer_norm_eps, False, pb.wrap(fe.rms_norm_rows),
                         pb.wrap(fe.gemm), pb.wrap(fa.flash_attention_fwd))
            checks.timed("t5_layer", f"B32 T512 t5-base {tag}", lambda: fe.fused_t5_layer_parts(x, mask, bias, l, **kw),
                         lambda: fe.t5_layer_reference(x, mask, bias, l, **kw), iters=5, parts_bound=pb)
    del params

    # ---- K3 decode cross-attention ----
    check_decode_attention(checks, g)


def decode_inputs(g: torch.Generator, B: int, H: int, dk: int, Te: int, kv_dtype: torch.dtype, lens=None):
    """One layer's packed cross cache for K3 as decode_step gives it: q (B, H,
    dk) f32, K2/V2 in `kv_dtype` (int8 with its channel scales), a key mask
    of `lens` valid keys (random in 1..Te when None); also the unpacked K/V
    (B, H, Te, dk) that SDPA reads."""
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.ops import decode_attention as da

    dev = g.device
    q = torch.randn((B, H, dk), generator=g, device=dev)
    k, v = (torch.randn((B, H, Te, dk), generator=g, device=dev) for _ in range(2))
    ks = vs = None
    if kv_dtype == torch.int8:
        k, ks = t5m._quantize_kv(k)
        v, vs = t5m._quantize_kv(v)
        ks, vs = ks[:, :, 0, :], vs[:, :, 0, :]
    else:
        k, v = k.to(kv_dtype), v.to(kv_dtype)
    k2, v2 = da.pack_decode_kv(k, v)
    n = torch.randint(1, Te + 1, (B,), generator=g, device=dev) if lens is None else torch.tensor(lens, device=dev)
    m = torch.arange(Te, device=dev)[None, :] < n[:, None]
    return dict(q=q, k2=k2, v2=v2, m=m, ks=ks, vs=vs, k=k, v=v)


def time_decode_layers(checks: Checks, label: str, layers: list, library: bool = False,
                       dtype: torch.dtype = torch.bfloat16) -> None:
    """Times K3 as a decode step runs it, the next of 12 distinct layer caches
    each call (back-to-back calls on one int8 cache would read the 50 MB L2,
    not device memory), by events and on the device; query and output in
    `dtype`, bf16 as decode_step asks for under bf16 weights. `library`: SDPA
    with a query length of 1 over the same 12 unpacked caches."""
    import torch.nn.functional as F

    from rag_docvqa_tpu_torch.ops import decode_attention as da

    qs = [L["q"].to(dtype) for L in layers]
    cycle = lambda: itertools.cycle(zip(qs, layers))
    it, pit, lit = cycle(), cycle(), cycle()

    def run():
        q, L = next(it)
        return da.fused_cross_attention(q, L["k2"], L["v2"], L["m"], L["ks"], L["vs"], out_dtype=dtype)

    def plain():
        q, L = next(pit)
        return da.cross_attention_reference(q, L["k2"], L["v2"], L["m"], L["ks"], L["vs"], dtype)

    def sdpa():
        q, L = next(lit)
        return F.scaled_dot_product_attention(q[:, :, None, :], L["k"], L["v"], attn_mask=L["m"][:, None, None, :],
                                              scale=1.0)

    L = layers[0]
    B, H, dk = L["q"].shape
    Te = L["k2"].shape[2]
    checks.timed("decode_cross_attention", label, run, plain, iters=24, library=sdpa if library else None,
                 library_is=f"SDPA, query length 1, {op_type(dtype)} math" if library else "",
                 io_bytes=nbytes(qs[0], L["k2"], L["v2"], L["m"], L["ks"], L["vs"]) + B * H * dk * qs[0].element_size(),
                 ops=4.0 * B * H * Te * dk, device=True)


def check_decode_attention(checks: Checks, g: torch.Generator) -> None:
    """K3 against its plain version at the edges of its design: Te 1, 77,
    513, 709 and 2048 (rows of K2 not 16-byte aligned; tails shorter than a
    16-byte vector and than a split), dk 40 (int8: V2's head slices not
    16-byte aligned) and 128, B 1, rows with one and with no valid key, a split
    whose every key is masked between valid ones; f32, bf16 and int8 caches;
    f32 and bf16 queries; each split length (128, 256 and 512 bytes of a K2
    row a block: one kernel, or split and combine) and the wrapper's own
    choice. f32 output
    within F32_TOL (f32 math on the stored values in both); the bf16 output
    is the f32 output rounded, bit for bit, and a second launch gives the
    same bits. Then the main path's shape, timed over 12 distinct caches,
    and the CUDA graph of one int8 call: K3's kernels and nothing else."""
    from rag_docvqa_tpu_torch.ops import decode_attention as da

    cases = (((3, 4, 40, 77, [77, 30, 1]), "ragged"), ((1, 12, 64, 1, [1]), "B1 Te1"),
             ((2, 4, 128, 513, [513, 0]), "dk128 Te513, a row with no valid key"),
             ((4, 6, 40, 709, [709, 1, 300, 0]), "dk40 Te709, one and no valid key"),
             ((2, 12, 64, 2048, None), "Te2048, a split of masked keys"),
             ((32, 12, 64, 512, None), "B32 H12 dk64 Te512"))
    for kv_dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16"), (torch.int8, "int8")):
        for (B, H, dk, Te, lens), label in cases:
            L = decode_inputs(g, B, H, dk, Te, kv_dtype, lens)
            if Te == 2048:
                L["m"][1] = True
                L["m"][1, 256:768] = False  # masked splits of either length between valid keys
            for q_dtype in (torch.float32, torch.bfloat16):
                q = L["q"].to(q_dtype)
                args = (L["k2"], L["v2"], L["m"], L["ks"], L["vs"])
                want = da.cross_attention_reference(q, *args)
                qtag = "f32" if q_dtype == torch.float32 else "bf16"
                got = da.fused_cross_attention(q, *args)
                checks.compare("decode_cross_attention", f"{label} {tag} cache, {qtag} q", got, want, F32_TOL)
                for split in (128 // L["k2"].element_size(), 256 // L["k2"].element_size(), 512 // L["k2"].element_size()):
                    f32 = da._launch(q, *args, torch.float32, split)
                    bf = da._launch(q, *args, torch.bfloat16, split)
                    err = checks.compare("decode_cross_attention", f"{label} {tag} cache, {qtag} q, split {split}",
                                         f32, want, F32_TOL)
                    if not (torch.equal(bf, f32.bfloat16()) and torch.equal(f32, da._launch(q, *args, torch.float32, split))):
                        raise AssertionError(f"decode_cross_attention {label} {tag} split {split}: the bf16 output is "
                                             f"not the f32 one rounded, or a second launch gave other bits ({err})")

    # the main path's shape: int8 (the served cache) and bf16 (beside SDPA), 12 layer caches
    for kv_dtype, tag in ((torch.int8, "int8"), (torch.bfloat16, "bf16")):
        layers = [decode_inputs(g, 32, 12, 64, 512, kv_dtype) for _ in range(12)]
        time_decode_layers(checks, f"B32 H12 dk64 Te512 {tag} cache", layers, library=kv_dtype == torch.bfloat16)
        L, q = layers[0], layers[0]["q"].bfloat16()
        it = L["k2"].element_size()
        for split in (128 // it, 256 // it, 512 // it):  # the split length the wrapper chooses, against the others
            ms = device_ms(lambda: da._launch(q, L["k2"], L["v2"], L["m"], L["ks"], L["vs"], torch.bfloat16, split))
            log(f"  decode_cross_attention   B32 Te512 {tag} cache, split {split} keys (the wrapper's: "
                f"{da.split_len(32, 12, 512, it)}): {ms:.4f} ms on the device, one cache back to back")
        if kv_dtype == torch.int8:
            # one call as decode_step makes it: K3's split and combine kernels and no element-wise torch kernel
            call = lambda: da.fused_cross_attention(q, L["k2"], L["v2"], L["m"], L["ks"], L["vs"],
                                                    out_dtype=torch.bfloat16)
            nodes = graph_nodes(call)
            log(f"  decode_cross_attention   one int8 call runs {len(nodes)} graph nodes: {nodes}")
            if not (1 <= len(nodes) <= 2 and all("decode_attn_split_kernel" in n or "combine_kernel" in n for n in nodes)):
                raise AssertionError(f"decode_cross_attention: one call ran {nodes}, not K3's kernels alone")
        del layers


# --------------------------------------------------------------------------- #
# phase 4: the full-width f32 stack
# --------------------------------------------------------------------------- #
def check_stack(g: torch.Generator) -> None:
    from dataclasses import replace

    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models.layers import rms_norm
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe
    from rag_docvqa_tpu_torch.ops.decode import greedy_decode

    dev = g.device
    cfg = t5m.T5Config()
    params = t5m.init_t5_params(g, cfg)
    B, T = 8, 512
    x = torch.randn((B, T, cfg.d_model), generator=g, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < torch.tensor([512, 500, 431, 300, 257, 128, 64, 9], device=dev)[:, None]
    t0 = time.perf_counter()
    enc = t5m.encode(params, cfg, x, mask)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    pos = torch.arange(T)
    bias = t5m.relative_bias(params.encoder.rel_bias, pos, pos, True, cfg)[0].to(torch.bfloat16).contiguous()
    ref = x
    for l in fe.fuse_t5_blocks(params.encoder.layers, False):
        ref = fe.t5_layer_reference(ref, mask, bias, l, num_heads=cfg.num_heads, eps=cfg.layer_norm_eps, gated=False)
    ref = rms_norm(ref, params.encoder.final_ln, cfg.layer_norm_eps)
    err = (enc - ref).abs().max().item()
    log(f"  encode f32 t5-base B8 T512 (12 layers) kernels vs plain stack: max_abs_err {err:.3e} "
        f"(limit {F32_TOL:.0e}), max|ref| {ref.abs().max().item():.3g}, {enc_s * 1e3:.1f} ms")
    if not err <= F32_TOL:
        raise AssertionError(f"full-width encode differs from the plain stack by {err}")
    # the bf16 cache: the encoder output in bf16 under the f32 weights, so the
    # cache (and K3's loads) are bf16 while the attention math stays f32
    for cache, hidden in (("f32", enc), ("bf16", enc.bfloat16()), ("int8", enc)):
        ids = {}
        for fused in (False, True):
            c = replace(cfg, decode_kv_int8=cache == "int8", fused_decode_attn=fused)
            toks, conf = greedy_decode(params, c, hidden, mask, max_new_tokens=16)
            if not torch.isfinite(conf).all():
                raise AssertionError("non-finite confidence")
            ids[fused] = toks.cpu()
        same = torch.equal(ids[False], ids[True])
        log(f"  greedy decode 16 steps, {cache} cache: ids identical with the decode kernel "
            f"on and off: {same}")
        if not same:
            raise AssertionError("decoded ids differ with fused_decode_attn on and off")


# --------------------------------------------------------------------------- #
# phase 5: the main path through the engine
# --------------------------------------------------------------------------- #
def serve(g: torch.Generator):
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
    from rag_docvqa_tpu_torch.metrics.anls import anls
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    # configs/RAGVT5.yml: t5-base widths, chunk_num 10, chunk_size 60,
    # overlap 10, max_source_length 512; 16 new tokens here
    tok = HashTokenizer(32128)
    ingestor = DocVQAIngestor(tok, ChunkSpec(chunk_size=60, overlap=10), Caps())
    docs = make_corpus(96, n_pages=8, words_per_page=120, seed=SEED)
    ingestor.caps = ingestor.plan_caps(docs)
    t0 = time.perf_counter()
    batches = [ingestor.ingest(docs[i:i + 32]) for i in range(0, 96, 32)]
    log(f"  host ingest of 3 x 32 docs (8 pages x 120 words): {time.perf_counter() - t0:.3f} s, caps {ingestor.caps}")
    vt5_cfg = vt5m.VT5Config(t5=t5m.T5Config(decode_kv_int8=True, fused_decode_attn=True))
    params = vt5m.init_vt5_params(g, vt5_cfg).to(torch.bfloat16)
    engine = RAGVT5Engine(RAGConfig(page_retrieval="concat", chunk_num=10, include_surroundings=0,
                                    max_source_length=512, max_new_tokens=16), vt5_cfg, params, tok)
    engine.inference(*batches[0])  # warmup, not counted
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    results = []
    for batch, aux in batches[1:]:
        t0 = time.perf_counter()
        out = engine.inference(batch, aux)
        wall = time.perf_counter() - t0
        results.append((out, aux, wall))
    launches = dict(kernels.LAUNCHES)

    for i, (out, aux, wall) in enumerate(results):
        t = out["timings"]
        conf = out["confidences"]
        if len(out["pred_answers"]) != 32 or not all(math.isfinite(c) and 0.0 < c <= 1.0 + 1e-6 for c in conf):
            raise AssertionError(f"batch {i}: bad answers or confidences {conf}")
        score = sum(max(anls(a, p) for a in gold) for gold, p in zip(aux["answers"], out["pred_answers"])) / 32
        log(f"  batch {i}: {wall * 1e3:.1f} ms wall incl. host->device copy and detokenize; "
            f"retrieve+assemble {t['retrieve_assemble_s'] * 1e3:.2f} ms, encode {t['encode_s'] * 1e3:.2f} ms, "
            f"decode {t['decode_s'] * 1e3:.2f} ms; ANLS {score:.4f} (random weights)")
    log(f"  launches in the two served batches: {launches}")
    check_launched(launches, SERVE_KERNELS, "serving")
    decode_step_kernels(params.t5, vt5_cfg.t5, g)
    return launches


def decode_step_kernels(params, cfg, g: torch.Generator) -> None:
    """The device work of one decode step as the served batch runs it (B 32,
    Te 512, bf16 weights, int8 cache, K3 on): the CUDA kernels and copies in
    a profiler trace of one `decode_step`, K3's among them."""
    from torch.profiler import ProfilerActivity, profile

    from rag_docvqa_tpu_torch.models import t5 as t5m

    dev = g.device
    B, Te, T = 32, 512, 16
    enc = torch.randn((B, Te, cfg.d_model), generator=g, device=dev).bfloat16()
    mask = torch.arange(Te, device=dev)[None, :] < torch.randint(1, Te + 1, (B, 1), generator=g, device=dev)
    cache = t5m.init_decode_cache(params, cfg, enc, T)
    bias = t5m.decoder_self_bias(params, cfg, T)
    token = torch.zeros(B, dtype=torch.int64, device=dev)
    t5m.decode_step(params, cfg, cache, token, 0, mask, self_bias=bias[:, :, 0, :])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t5m.decode_step(params, cfg, cache, token, 1, mask, self_bias=bias[:, :, 1, :])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    k3 = sum(1 for n in names if "decode_attn_split_kernel" in n or "combine_kernel" in n)
    log(f"  one decode step (B {B}, Te {Te}, {cfg.num_decoder_layers} layers, bf16, int8 cache, K3 on): {len(names)} "
        f"CUDA kernels and copies, {k3} of them K3's")


# --------------------------------------------------------------------------- #
# phase 5b: the other nine strategies, the eval entry point and the NAC
# --------------------------------------------------------------------------- #
STRATEGY_B, STRATEGY_K = 32, 10  # the served batch and chunk_num: B * K = 320 per-chunk or page rows


def serve_strategies(g: torch.Generator):
    """5b: every strategy serves one warmup and one counted batch of 32 through
    RAGVT5Engine.inference with phase 5's configuration (configs/RAGVT5.yml
    widths, chunk_num 10, per_chunk_seq_len 256, max_source_length 512, bf16,
    int8 cross cache, K3 on, 16 new tokens); the counts are set to 0 just
    before each counted batch and read just after."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps, to_device
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import STRATEGIES, RAGConfig, RAGVT5Engine, retrieve
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec
    from rag_docvqa_tpu_torch.ops.gather import AssembleConfig, assemble_page_rows, assemble_per_chunk

    tok = HashTokenizer(32128)
    ingestor = DocVQAIngestor(tok, ChunkSpec(chunk_size=60, overlap=10), Caps())
    docs = make_corpus(2 * STRATEGY_B, n_pages=8, words_per_page=120, seed=SEED + 5)
    ingestor.caps = ingestor.plan_caps(docs)
    batches = [ingestor.ingest(docs[i:i + STRATEGY_B]) for i in (0, STRATEGY_B)]
    vt5_cfg = vt5m.VT5Config(t5=t5m.T5Config(decode_kv_int8=True, fused_decode_attn=True))
    params = vt5m.init_vt5_params(g, vt5_cfg).to(torch.bfloat16)

    # the valid keys of the rows K1 and K2 get: no row may reach them without one
    batch = to_device(batches[1][0], g.device)
    ret = retrieve(params.t5.shared, batch, k=STRATEGY_K)
    per_chunk = assemble_per_chunk(batch, ret.top_k_idx, ret.top_k_valid, AssembleConfig(), seq_len=256)[0]
    page_rows = assemble_page_rows(batch, ret.top_k_page, ret.top_k_valid, AssembleConfig(max_source_length=512))
    lens = {}
    for name, gen in (("per-chunk", per_chunk), ("page", page_rows)):
        n = gen.attention_mask.sum(dim=1)
        lens[name] = {"rows": int(n.numel()), "T": int(gen.attention_mask.shape[1]), "min": int(n.min()),
                      "median": float(n.float().median()), "max": int(n.max())}
        log(f"  {name} rows: {n.numel()} of T {gen.attention_mask.shape[1]}, valid keys min {int(n.min())}, median "
            f"{float(n.float().median()):.0f}, max {int(n.max())}")
        if int(n.min()) < 1:
            raise AssertionError(f"a {name} row reaches the encoder with no valid key")

    launches, rows = {}, {}
    for strategy in STRATEGIES:
        engine = RAGVT5Engine(RAGConfig(page_retrieval=strategy, chunk_num=STRATEGY_K, include_surroundings=0,
                                        max_source_length=512, per_chunk_seq_len=256, max_new_tokens=16),
                              vt5_cfg, params, tok)
        engine.inference(*batches[0])  # warmup, not counted
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = engine.inference(*batches[1])
        wall = (time.perf_counter() - t0) * 1e3
        launches[strategy] = dict(kernels.LAUNCHES)
        check_launched(launches[strategy], SERVE_KERNELS, f"{strategy} serving")
        # a product of 15 maxima of a near-uniform softmax over 32,128 words (random weights) can
        # underflow f32 to 0: finite and inside [0, 1] is the check
        confs = [c for x in out["confidences"] for c in (x if isinstance(x, list) else [x]) if c is not None]
        if len(out["pred_answers"]) != STRATEGY_B or not confs or \
                not all(math.isfinite(c) and 0.0 <= c <= 1.0 + 1e-6 for c in confs):
            raise AssertionError(f"{strategy}: bad answers or confidences {out['confidences']}")
        t = out["timings"]
        rows[strategy] = {"ms": wall, "retrieve_assemble_ms": t["retrieve_assemble_s"] * 1e3,
                          "encode_ms": t["encode_s"] * 1e3, "decode_ms": t["decode_s"] * 1e3,
                          "confidences": len(confs), "zero_confidences": sum(c == 0.0 for c in confs),
                          "launches": {k: launches[strategy][k] for k in SERVE_KERNELS}}
        log(f"  {strategy:15s} {wall:8.1f} ms a batch of {STRATEGY_B}: retrieve+assemble "
            f"{rows[strategy]['retrieve_assemble_ms']:.2f}, encode {rows[strategy]['encode_ms']:.2f}, decode "
            f"{rows[strategy]['decode_ms']:.2f} ms; {len(confs)} confidences ({rows[strategy]['zero_confidences']} "
            f"underflowed to 0); launches {rows[strategy]['launches']}")
    return launches, {"strategies": rows, "rows": lens}


def t5_layer_case(checks: Checks, g: torch.Generator, B: int, T: int, label: str) -> None:
    """The whole K1 layer (t5_rms_norm, t5_gemm, K2 with the shared bias) at
    t5-base width in bf16 against the plain layer, rows of 1 to T valid
    keys, timed beside the plain layer (and on the device) with the sum of
    its parts' bounds."""
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    cfg = t5m.T5Config()
    params = t5m.init_t5_params(g, t5m.T5Config(num_encoder_layers=1, num_decoder_layers=1))
    l = {k: v.bfloat16() for k, v in fe.fuse_t5_blocks(params.encoder.layers, False)[0].items()}
    pos = torch.arange(T)
    bias = t5m.relative_bias(params.encoder.rel_bias, pos, pos, True, cfg)[0].to(torch.bfloat16).contiguous()
    mask = torch.arange(T, device=dev)[None, :] < (1 + (torch.arange(B, device=dev) * 97) % T)[:, None]
    x = torch.randn((B, T, cfg.d_model), generator=g, device=dev).bfloat16()
    kw = dict(num_heads=cfg.num_heads, eps=cfg.layer_norm_eps, gated=False)
    got = fe.fused_t5_layer_parts(x, mask, bias, l, **kw)
    want = fe.t5_layer_reference(x, mask, bias, l, **kw)
    checks.compare("t5_layer", label, got, want, tol(torch.bfloat16, want))
    del got, want
    pb = PartsBound()
    fe._t5_layer(x, mask, bias, l, cfg.num_heads, cfg.layer_norm_eps, False, pb.wrap(fe.rms_norm_rows),
                 pb.wrap(fe.gemm), pb.wrap(fa.flash_attention_fwd))
    checks.timed("t5_layer", label, lambda: fe.fused_t5_layer_parts(x, mask, bias, l, **kw),
                 lambda: fe.t5_layer_reference(x, mask, bias, l, **kw), iters=3, parts_bound=pb, device=True)


def check_strategy_kernels(checks: Checks, g: torch.Generator) -> dict:
    """K1, K2 and K3 at the shapes the per-chunk and page-row strategies give
    them: 320 rows of T 256 and of T 512, and a decode at B 320 over int8
    cross caches of Te 256 and 512; each against its plain version, timed
    beside it and its library call (SDPA for K2, and for K3 on a bf16 cache),
    with the device time."""
    from rag_docvqa_tpu_torch.ops import decode_attention as da
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    B = STRATEGY_B * STRATEGY_K
    for T in (256, 512):
        t5_layer_case(checks, g, B, T, f"B{B} T{T} t5-base bf16")
        torch.cuda.empty_cache()
        flash_case(checks, g, B, T, 12, 12, 64, torch.bfloat16, "shared", False, 1.0, fe.T5_MASK_VALUE,
                   [1 + (i * 97) % T for i in range(B)], f"B{B} H12 T{T} dk64 shared bias bf16", timed=True,
                   device=True)
        torch.cuda.empty_cache()
    splits = {}
    for Te, kv_dtype, tag in ((256, torch.int8, "int8"), (256, torch.bfloat16, "bf16"), (512, torch.int8, "int8")):
        layers = [decode_inputs(g, B, 12, 64, Te, kv_dtype) for _ in range(12)]
        L = layers[0]
        args = (L["k2"], L["v2"], L["m"], L["ks"], L["vs"])
        for q_dtype in (torch.float32, torch.bfloat16):
            q = L["q"].to(q_dtype)
            checks.compare("decode_cross_attention", f"B{B} H12 dk64 Te{Te} {tag} cache, {str(q_dtype)[6:]} q",
                           da.fused_cross_attention(q, *args), da.cross_attention_reference(q, *args), F32_TOL)
        time_decode_layers(checks, f"B{B} H12 dk64 Te{Te} {tag} cache", layers, library=kv_dtype == torch.bfloat16)
        split = da.split_len(B, 12, Te, L["k2"].element_size(), torch.cuda.get_device_properties(0).multi_processor_count)
        q = L["q"].bfloat16()
        nodes = graph_nodes(lambda: da.fused_cross_attention(q, *args, out_dtype=torch.bfloat16))
        splits[f"Te{Te} {tag}"] = {"split_keys": split, "splits": -(-Te // split), "graph_nodes": nodes}
        log(f"  decode_cross_attention   B{B} Te{Te} {tag} cache: the wrapper splits the cache into {-(-Te // split)} "
            f"of {split} keys; one call's graph: {nodes}")
        del layers, L, args, q
        torch.cuda.empty_cache()
    return splits


def eval_cli() -> dict:
    """The port's eval entry point, in this process, at t5-base width
    (configs/RAGVT5.yml, f32 weights as the CLI builds them) over 64 synthetic
    documents with maxconf and the ingest statistics; 16 new tokens."""
    from rag_docvqa_tpu_torch import eval as port_eval

    t0 = time.perf_counter()
    summary = port_eval.main(["-m", os.path.join(REPO, "configs/RAGVT5.yml"),
                              "-d", os.path.join(REPO, "configs/Synthetic.yml"), "page_retrieval=maxconf",
                              "compute_stats=true", "n_val_docs=64", "max_new_tokens=16"])
    wall = time.perf_counter() - t0
    keys = {"accuracy", "anls", "retrieval_precision", "chunk_score", "n_samples", "page_retrieval", "wall_time"}
    if len(summary) != 1 or set(summary[0]) != keys or summary[0]["n_samples"] != 64 or \
            summary[0]["page_retrieval"] != "maxconf" or not 0.0 <= summary[0]["retrieval_precision"] <= 1.0:
        raise AssertionError(f"eval CLI summary: {summary}")
    log(f"  eval CLI: {summary[0]} ({wall:.1f} s in all)")
    return dict(summary[0], total_s=wall)


def train_nac(g: torch.Generator, steps: int = 4):
    """5b: t5-base VT5 train steps with the NAC term at phase 6d's shapes (B 8,
    8 pages x 120 words, bf16 compute, f32 masters), its greedy decode of 16
    tokens over an int8 cross cache through K3; on one repeated batch, the
    losses finite and the NAC loss falling. Only the NAC trains here, on the
    frozen generator (lr 2e-4, the yml's, after one warmup step: the last loss
    comes after two updates): trained jointly, the generator's first updates
    change its decoded answers, the NAC's inputs, and the NAC loss rose at
    the fourth step at lr 2e-4 and 1e-3 alike. 6d trains the generator."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps, to_device
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.models.nac import NACConfig, init_nac_params
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec
    from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
    from rag_docvqa_tpu_torch.training.train_step import TrainState, make_train_step

    dev = g.device
    ingestor = DocVQAIngestor(HashTokenizer(32128), ChunkSpec(chunk_size=60, overlap=10), Caps())
    docs = make_corpus(8, n_pages=8, words_per_page=120, seed=SEED + 6)
    ingestor.caps = ingestor.plan_caps(docs)
    batch, aux = ingestor.ingest(docs)
    batch = to_device(batch, dev)
    labels = torch.from_numpy(ingestor.answer_labels(aux["answers"], max_len=32, seed=SEED)).to(dev)
    nac_labels = torch.tensor([1.0, 0.0] * 4, device=dev)  # half of them marked not answerable
    vt5_cfg = vt5m.VT5Config(t5=t5m.T5Config(decode_kv_int8=True, fused_decode_attn=True))
    params = vt5m.init_vt5_params(g, vt5_cfg)  # f32 masters
    params.nac = init_nac_params(g, NACConfig(emb_dim=768))
    rag = RAGConfig(page_retrieval="concat", chunk_num=10, include_surroundings=0, max_source_length=512)
    opt = build_optimizer(lr=2e-4, warmup_steps=1, total_steps=10 * steps,
                          mask=trainable_mask(params, ("nac",)))
    state = TrainState.create(params, opt)
    step = make_train_step(vt5_cfg, rag, opt, bf16_compute=True, use_nac=True)
    kernels.reset_launch_counts()
    rows = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, labels, nac_labels)
        torch.cuda.synchronize()
        rows.append({k: m[k].item() for k in ("loss", "nac_loss", "nac_accuracy", "grad_norm", "grad_norm/nac")})
        rows[-1]["wall_ms"] = (time.perf_counter() - t0) * 1e3
        log(f"  step {i + 1}: loss {rows[-1]['loss']:.4f}, nac_loss {rows[-1]['nac_loss']:.4f}, nac_accuracy "
            f"{rows[-1]['nac_accuracy']:.3f}, grad norm of the NAC {rows[-1]['grad_norm/nac']:.4f}, "
            f"{rows[-1]['wall_ms']:.1f} ms")
    launches = dict(kernels.LAUNCHES)
    log(f"  launches in the {steps} NAC train steps: {launches}")
    check_launched(launches, SERVE_KERNELS, "NAC training")  # the forward's K1 parts and K2, the decode's K3
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["nac_loss"]) for r in rows):
        raise AssertionError("non-finite loss or NAC loss")
    if not rows[-1]["nac_loss"] < rows[0]["nac_loss"]:
        raise AssertionError(f"the NAC loss did not fall on the repeated batch: {[r['nac_loss'] for r in rows]}")
    return launches, {"steps": rows, "ms": sum(r["wall_ms"] for r in rows[1:]) / (steps - 1),
                      "case": "t5-base VT5 B8 T512 bf16 compute + NAC (16-token decode, int8 cache, K3)"}


# --------------------------------------------------------------------------- #
# phase 6: the training path
# --------------------------------------------------------------------------- #
def kernel_relu_masks(x1s, ln1s, wis, eps):
    """The ReLU decisions the kernels' backward takes in each layer: the
    sign of the pre-activation rms(x1) . Wi^T as csrc/t5_layer_bwd.cu
    recomputes it. ReLU's derivative is a step, so where the kernel and a
    plain f32 GEMM, summing in another order, round a pre-activation within
    ~1e-6 of zero to opposite signs, a gradient differs by a whole term; the
    gradient checks give the plain reference these decisions, so they measure
    the arithmetic, and count the positions where the plain signs differ."""
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    masks = []
    for x1, ln1, wi in zip(x1s, ln1s, wis):
        h2 = fe.rms_norm_rows(x1.reshape(-1, x1.shape[-1]).contiguous(), ln1.to(x1.dtype), eps)
        zeros = torch.zeros((h2.shape[0], wi.shape[0]), dtype=h2.dtype, device=h2.device)
        masks.append(fe.gemm_bwd(h2, wi.to(h2.dtype), "nt", "relu_bwd", zeros)[1] > 0)
    return masks


class MaskedRelu:
    """Plain GEMMs whose ReLU takes the given decisions, one mask per layer
    in order; counts where the plain pre-activation's sign differs."""

    def __init__(self, masks):
        self.masks, self.flips = iter(masks), 0

    def _mask(self, pre):
        m = next(self.masks)
        self.flips += int(((pre > 0) != m).sum())
        return m

    def gemm(self, a, w, epilogue="none", aux=None):
        from rag_docvqa_tpu_torch.ops import fused_encoder as fe

        if epilogue != "relu":
            return fe.gemm_reference(a, w, epilogue, aux)
        pre = torch.matmul(a.float(), w.float().t())
        return torch.where(self._mask(pre), pre, 0.0).to(a.dtype)

    def gemm_bwd(self, a, b, layout, epilogue, aux0=None, aux1=None, acc=None):
        from rag_docvqa_tpu_torch.ops import fused_encoder as fe

        if epilogue != "relu_bwd":
            return fe.gemm_bwd_reference(a, b, layout, epilogue, aux0, aux1, acc)
        pre = torch.matmul(a.float(), b.float().t())
        m = self._mask(pre)
        return torch.where(m, aux0.float(), 0.0).to(a.dtype), torch.where(m, pre, 0.0).to(a.dtype)


def sdpa_bwd_library(q, k, v, out_grad, mask, bias, scale, mask_value):
    """The library call for K6: the backward kernels of
    F.scaled_dot_product_attention (torch.autograd.grad of one forward graph,
    kept), in the (B, H, T, dh) layout SDPA takes; the key mask as a boolean
    mask without a bias, or summed with the bias into one float mask, the
    (1, H, T, T) bias expanded so that autograd sums its gradient over the
    batch. Returns the function that runs the backward once."""
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    ins = [qt, kt, vt]
    if bias is None:
        attn = mask[:, None, None, :]
    else:
        bt = bias.to(q.dtype).detach().requires_grad_()
        ins.append(bt)
        off = torch.where(mask, 0.0, mask_value).to(q.dtype)[:, None, None, :]
        attn = bt.expand(q.shape[0], -1, -1, -1) + off
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn, scale=scale)
    do = out_grad.transpose(1, 2)
    return lambda: torch.autograd.grad(o, ins, do, retain_graph=True)


def kernel_names(fn) -> str:
    """The CUDA kernels of one call of `fn`, by name and device time, the
    longest first: which backend a library call ran."""
    fn()
    torch.cuda.synchronize()
    times = sorted(kernel_times(fn, 5).items(), key=lambda x: -x[1])
    return "; ".join(f"{n[:60]} {t:.1f} us" for n, t in times[:4] if t > 0)


def flash_bwd_case(checks: Checks, gen: torch.Generator, B, T, H, Hkv, dh, dtype, bias_kind, causal, scale,
                   mask_value, lens, label, timed=False) -> None:
    """K6 against its plain version, both from the same forward; `lens` as
    flash_case takes it. `timed`: a second launch must give the same bits,
    and the kernel is timed beside SDPA's backward."""
    from rag_docvqa_tpu_torch.ops import flash_attention as fa

    dev = gen.device
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    q, do = randn(B, T, H, dh).to(dtype), randn(B, T, H, dh).to(dtype)
    k, v = randn(B, T, Hkv, dh).to(dtype), randn(B, T, Hkv, dh).to(dtype)
    mask = key_mask(lens, T, dev)
    bias = None
    if bias_kind:
        bias = randn(B if bias_kind == "per-batch" else 1, H, T, T).to(
            torch.bfloat16 if dtype == torch.bfloat16 else torch.float32)
    args = (mask, bias, scale, causal, mask_value)
    out, lse = fa.flash_attention_reference(q, k, v, *args)
    out = out.contiguous()  # as K2 returns it: the kernel's wrapper would copy a strided one
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, *args)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        if b is not None:
            checks.compare("flash_bwd", f"{label} {name}", a, b, rel_tol(dtype, b))
    if not timed:
        return
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
    if not all(a is None or torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_bwd {label}: a second launch on the same input gave other bits")
    library = sdpa_bwd_library(q, k, v, do, mask, bias, scale, mask_value)
    backend = kernel_names(library)
    log(f"  flash_bwd library at {label}: {backend}")
    # the function's five products of 2*T*T*dh each per head (S, dP, dV, dK, dQ; the kernel's dQ pass
    # recomputes S and dP, seven in all)
    checks.timed("flash_bwd", label, lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, *args),
                 lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, *args), library=library,
                 library_is="autograd.grad through F.scaled_dot_product_attention (dq, dk, dv"
                            + (", the bias summed over the batch" if bias is not None else "") + "): " + backend,
                 io_bytes=nbytes(q, k, v, out, lse, do, mask, bias, *got), ops=10.0 * B * H * T * T * dh,
                 ops_in=op_type(dtype), device=True)


def check_flash_bwd(checks: Checks, g: torch.Generator) -> None:
    """6a: K6 against its plain version, both from the same forward; its two
    timed shapes (the train step's and the contrastive step's) beside the
    backward of SDPA, a second launch's bits."""
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    check_hgmma("flash_bwd.cu")

    def case(*args, gen=g, **kw):
        flash_bwd_case(checks, gen, *args, **kw)

    t5m = fe.T5_MASK_VALUE
    # the cases added after the first five draw from their own generator, so that every later phase's data
    # stay what the shared one gave them before
    g_new = torch.Generator(device=dev).manual_seed(SEED + 6)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        case(3, 77, 4, 2, 40, dtype, "per-batch", True, 0.5, fa.NEG_INF, [77, 50, 0], f"ragged gqa causal per-batch {tag}")
        case(3, 77, 4, 4, 128, dtype, "shared", False, 1.0, t5m, [77, 30, 0], f"ragged dh128 shared t5-mask {tag}")
        case(2, 45, 4, 1, 64, dtype, None, False, 1.0, fa.NEG_INF, [45, 0], f"ragged gqa4 no bias {tag}")
        case(2, 45, 4, 4, 64, dtype, None, True, 1.0, t5m, [45, 20], f"ragged causal t5-mask no bias {tag}")
        case(3, 64, 4, 4, 128, dtype, None, False, 0.5, fa.NEG_INF, [64, 33, 0], f"ragged dh128 T64 no bias {tag}",
             gen=g_new)
        case(3, 57, 4, 4, 40, dtype, None, False, 0.5, t5m, [57, 9, 0], f"ragged dh40 T57 t5-mask no bias {tag}",
             gen=g_new)
        case(8, 512, 12, 12, 64, dtype, "shared", False, 1.0, t5m, [512 - 40 * i for i in range(8)],
             f"B8 H12 T512 dk64 shared bias t5-mask {tag}", timed=dtype == torch.bfloat16)
    # the contrastive step's attention (K10): bge-small, no bias, -1e30, ragged keys; and one sequence with none
    B, T, H, dh = CONTRASTIVE_B, BERT_T, BGE["num_heads"], BGE["hidden_size"] // BGE["num_heads"]
    lens = ragged_mask(B, T, dev).sum(1).tolist()
    case(B, T, H, H, dh, torch.bfloat16, None, False, dh**-0.5, fa.NEG_INF, lens,
         f"B{B} H{H} T{T} dh{dh} no bias ragged bf16", timed=True, gen=g_new)
    case(B, T, H, H, dh, torch.bfloat16, None, False, dh**-0.5, fa.NEG_INF, [0] + lens[1:],
         f"B{B} H{H} T{T} dh{dh} no bias, one sequence without keys bf16", gen=g_new)


# backward-GEMM shapes that cut the bf16 kernel's 128-row and 128- or 256-column
# tiles and its 64-deep K steps (NT and NN; TN takes M and N multiples of 8),
# and one that takes the 128 x 256 tile (gemm_wide_tile: K >= 1024, N % 256 == 0,
# at least 264 wide tiles)
GEMM_BWD_EDGES = ((129, 136, 72), (77, 264, 200))
GEMM_BWD_TN_EDGE = (136, 264, 1031)
GEMM_BWD_WIDE = (8192, 1280, 1024)


def gemm_bwd_case(checks: Checks, g: torch.Generator, layout: str, epi: str, M: int, N: int, K: int,
                  dtype: torch.dtype, label: str, *, twice: bool = False, timed: bool = False, splits=None):
    """One backward GEMM (t5_gemm_bwd or bert_gemm_bwd by its epilogue)
    against `gemm_bwd_reference` on seeded operands of unit scale; relu_bwd's
    dpre follows the kernel's own sign. `twice`: a second launch must give the
    same bits; `timed`: time it beside `torch.matmul` at the same layout (the
    bare product, bf16 out, where the epilogue does more); `splits` forces a
    TN product's number of row ranges."""
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    unit = "bert_gemm_bwd" if fe.BWD_EPILOGUES[epi] >= 5 else "t5_gemm_bwd"
    a = (randn(K, M) if layout == "tn" else randn(M, K)).to(dtype)
    b = ((randn(N, K) if layout == "nt" else randn(K, N)) * K**-0.5).to(dtype)
    make = {"c": lambda: randn(M, N).to(dtype), "f": lambda: randn(M, N), "b": lambda: (randn(N) * 0.5).to(dtype)}
    aux = [make[kind]() for kind in fe.BWD_PAIRS[(layout, epi)][1]]
    acc0 = randn(M, N) if epi == "acc_f32" else None  # both add into a copy of one f32 start
    tn_splits = fe.tn_splits
    if splits is not None:
        fe.tn_splits = lambda *_: splits
    try:
        run = lambda: fe.gemm_bwd(a, b, layout, epi, *aux, acc=None if acc0 is None else acc0.clone())
        got = run()
        outs = got if isinstance(got, tuple) else (got,)
        want = fe.gemm_bwd_reference(a, b, layout, epi, *aux, acc=None if acc0 is None else acc0.clone())
        want = want if isinstance(want, tuple) else (want,)
        checked = list(zip(outs, want))
        if epi == "relu_bwd":
            # dpre follows the kernel's own sign decision (see kernel_relu_masks)
            checks.compare(unit, f"{label} dpre", outs[0], torch.where(outs[1] > 0, aux[0], torch.zeros_like(aux[0])), 0.0)
            checked = checked[1:]
        for i, (x, y) in enumerate(checked):
            checks.compare(unit, f"{label} out{i + (epi == 'relu_bwd')}", x, y, tol(dtype, y))
        if twice:
            again = run()
            if not all(torch.equal(x, y) for x, y in zip(outs, again if isinstance(again, tuple) else (again,))):
                raise AssertionError(f"{unit} {label}: a second launch on the same input gave other bits")
        if timed:
            library = {"nt": lambda: torch.matmul(a, b.t()), "nn": lambda: torch.matmul(a, b),
                       "tn": lambda: torch.matmul(a.t(), b)}[layout]
            checks.timed(unit, label, lambda: fe.gemm_bwd(a, b, layout, epi, *aux, acc=acc0),
                         lambda: fe.gemm_bwd_reference(a, b, layout, epi, *aux, acc=acc0), library=library,
                         library_is="torch.matmul: the bare product, bf16 out", io_bytes=nbytes(a, b, *aux, *outs),
                         ops=2.0 * M * N * K, ops_in=op_type(dtype), device=True)
    finally:
        fe.tn_splits = tn_splits


def check_gemm_bwd_edges(checks: Checks, g: torch.Generator, bert: bool) -> None:
    """Every (layout, epilogue) pair of one backward entry point (bert_gemm_bwd
    or t5_gemm_bwd) at the bf16 kernel's tile edges, bf16 and f32, a second
    bf16 launch's bits; the 128 x 256 tile; TN over 1,031 rows in 1 and 3
    ranges."""
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    pairs = sorted(p for p in fe.BWD_PAIRS if (fe.BWD_EPILOGUES[p[1]] >= 5) == bert)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for layout, epi in pairs:
            shapes = [(GEMM_BWD_TN_EDGE, 1), (GEMM_BWD_TN_EDGE, 3)] if layout == "tn" else \
                [(shape, None) for shape in GEMM_BWD_EDGES] + ([(GEMM_BWD_WIDE, None)] if dtype == torch.bfloat16 else [])
            for (M, N, K), splits in shapes:
                where = f" in {splits} ranges" if splits else ""
                gemm_bwd_case(checks, g, layout, epi, M, N, K, dtype, f"edge {layout} {epi} {M}x{N}x{K}{where} {tag}",
                              twice=dtype == torch.bfloat16, splits=splits)


def check_rms_bwd_edges(checks: Checks, dev, eps: float) -> None:
    """t5_rms_bwd at the edges of its forms: 1 and 77 rows; widths in its
    register buckets (768, 1024 in bf16), past them (1024 in f32, 4096: the
    element-wise form), and no multiple of the 16-byte vector (40 in bf16,
    100); every (x, weight) dtype pair; a second launch's bits. Inputs from a
    generator of their own, so that later phases' data stay as they were."""
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    eg = torch.Generator(device=dev).manual_seed(SEED + 11)
    randn = lambda *s: torch.randn(s, generator=eg, device=dev)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for w_dtype, wtag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            for width in (40, 100, 768, 1024, 4096):
                for rows in (1, 77):
                    x, resid, dh = (randn(rows, width) * 3.0).to(dtype), randn(rows, width).to(dtype), randn(rows, width)
                    w = (torch.rand(width, generator=eg, device=dev) + 0.5).to(w_dtype)
                    got, want = fe.rms_norm_bwd(x, dh, w, resid, eps), fe.rms_norm_bwd_reference(x, dh, w, resid, eps)
                    label = f"edge {rows}x{width} x {tag} w {wtag}"
                    checks.compare("t5_rms_bwd", f"{label} dx", got[0], want[0], tol(dtype, want[0]))
                    checks.compare("t5_rms_bwd", f"{label} dw", got[1], want[1], rel_tol(dtype, want[1]))
                    again = fe.rms_norm_bwd(x, dh, w, resid, eps)
                    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                        raise AssertionError(f"t5_rms_bwd {label}: a second launch on the same input gave other bits")


def check_col_sum_edges(checks: Checks, dev) -> None:
    """bert_col_sum at the edges of its forms: 1 and 77 rows, widths that are
    16-byte chunks in both dtypes (768, 1024, 4096), in f32 only (100) and in
    neither (40 in bf16; 41), a row that starts off a 16-byte boundary (a
    column slice, contiguous again); a second launch's bits. Inputs from a
    generator of their own."""
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    eg = torch.Generator(device=dev).manual_seed(SEED + 12)
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (1, 77):
            for n in (40, 41, 100, 768, 1024, 4096):
                x = torch.randn(rows, n, generator=eg, device=dev).to(dtype)
                cases = [(x, f"edge {rows}x{n} {op_type(dtype)}")]
                if n == 768:
                    cases.append((torch.randn(rows * n + 1, generator=eg, device=dev).to(dtype)[1:].view(rows, n),
                                  f"edge {rows}x{n} {op_type(dtype)} off 16 bytes"))
                for xx, label in cases:
                    got, want = fe.col_sum(xx), fe.col_sum_reference(xx)
                    checks.compare("bert_col_sum", label, got, want, rel_tol(dtype, want))
                    if not torch.equal(got, fe.col_sum(xx)):
                        raise AssertionError(f"bert_col_sum {label}: a second launch on the same input gave other bits")


def check_layer_bwd(checks: Checks, g: torch.Generator) -> None:
    """6b: the backward GEMM and norm kernels, K7 and K8 against their plain
    versions, and T5LayerTrain's whole-layer gradient against autograd."""
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models.layers import rms_norm
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    cfg = t5m.T5Config()
    d, dff, H, eps = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.layer_norm_eps
    R = 8 * 512
    check_hgmma("t5_layer_bwd.cu")
    check_gemm_bwd_edges(checks, g, bert=False)
    check_rms_bwd_edges(checks, dev, eps)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for (layout, epi, M, N, K), label in (
                (("nt", "relu_bwd", 77, 96, 64), "ragged nt relu_bwd 77x96x64"),
                (("nt", "gelu_bwd", 77, 96, 64), "ragged nt gelu_bwd 77x96x64"),
                (("nn", "store", 77, 96, 64), "ragged nn 77x96x64"),
                (("nn", "acc_f32", 77, 96, 64), "ragged nn acc_f32 77x96x64"),
                (("tn", "store_f32", 96, 64, 77), "ragged tn 96x64 over 77 rows"),
                (("nt", "relu_bwd", R, dff, d), f"nt relu_bwd {R}x{dff}x{d}"),
                (("nn", "store_f32", R, d, dff), f"nn dh2 {R}x{d}x{dff} f32-out"),
                (("tn", "store_f32", dff, d, R), f"tn dWi {dff}x{d} over {R} rows")):
            path = not label.startswith("ragged")
            gemm_bwd_case(checks, g, layout, epi, M, N, K, dtype, f"{label} {tag}", twice=path and dtype == torch.bfloat16,
                          timed=path and dtype == torch.bfloat16)
        for rows, label in ((77, "77x768"), (R, f"{R}x768")):
            x, resid, dh = randn(rows, d).to(dtype), randn(rows, d).to(dtype), randn(rows, d)
            w = (torch.rand(d, generator=g, device=dev) + 0.5).to(dtype)
            got, want = fe.rms_norm_bwd(x, dh, w, resid, eps), fe.rms_norm_bwd_reference(x, dh, w, resid, eps)
            checks.compare("t5_rms_bwd", f"{label} {tag} dx", got[0], want[0], tol(dtype, want[0]))
            checks.compare("t5_rms_bwd", f"{label} {tag} dw", got[1], want[1], rel_tol(dtype, want[1]))
            if rows == R and dtype == torch.bfloat16:
                again = fe.rms_norm_bwd(x, dh, w, resid, eps)
                if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                    raise AssertionError(f"t5_rms_bwd {label} {tag}: a second launch on the same input gave other bits")
                x32, w32 = x.float(), w.float()

                def library():  # autograd of the one library RMSNorm call
                    xx, wx = x32.detach().requires_grad_(), w32.detach().requires_grad_()
                    return torch.autograd.grad(torch.nn.functional.rms_norm(xx, (d,), wx, eps), (xx, wx), dh)

                checks.timed("t5_rms_bwd", f"{label} {tag}", lambda: fe.rms_norm_bwd(x, dh, w, resid, eps),
                             lambda: fe.rms_norm_bwd_reference(x, dh, w, resid, eps), library=library,
                             library_is="autograd of F.rms_norm in f32: dx and dw, without the residual add",
                             io_bytes=nbytes(x, dh, w, resid, *got), ops=10.0 * rows * d, device=True)

    params = t5m.init_t5_params(g, t5m.T5Config(num_encoder_layers=1, num_decoder_layers=1))
    layer = fe.fuse_t5_blocks(params.encoder.layers, False)[0]
    layer["ln0"] = torch.rand(d, generator=g, device=dev) + 0.5
    layer["ln1"] = torch.rand(d, generator=g, device=dev) + 0.5
    B, T = 8, 512
    pos = torch.arange(T)
    bias = t5m.relative_bias(params.encoder.rel_bias, pos, pos, True, cfg)[0].to(torch.bfloat16).contiguous()
    mask = torch.arange(T, device=dev)[None, :] < torch.tensor([512 - 40 * i for i in range(B)], device=dev)[:, None]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        l = {k: v.detach().to(dtype) for k, v in layer.items()}
        x, x1, dy = randn(B, T, d).to(dtype), randn(B, T, d).to(dtype), randn(B, T, d).to(dtype)
        ffn = (x1, dy, l["ln1"], (l["wi"], l["wof"]))
        got = fe.t5_ffn_bwd(*ffn, eps=eps, gated=False)
        relu = MaskedRelu(kernel_relu_masks([x1], [l["ln1"]], [l["wi"]], eps))
        want = fe._ffn_bwd(*ffn, eps, False, rms_norm, fe.gemm_reference, relu.gemm_bwd, fe.rms_norm_bwd_reference)
        log(f"  ReLU signs where the plain f32 GEMM and the kernel differ, K7 {tag}: {relu.flips}")
        for name, a, b in zip(("dx1", "dln1", "dwi", "dwof"), (got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
            checks.compare("t5_ffn_bwd", f"B8 T512 t5-base {tag} {name}", a, b, rel_tol(dtype, b))
        att = (x, dy, mask, bias, l["wqkv"], l["wo"], l["ln0"])
        got, want = fe.t5_attn_bwd(*att, num_heads=H, eps=eps), fe.t5_attn_bwd_reference(*att, num_heads=H, eps=eps)
        for name, a, b in zip(("dx", "dln0", "dwqkv", "dwo", "dbias"), got, want):
            checks.compare("t5_attn_bwd", f"B8 T512 t5-base {tag} {name}", a, b, rel_tol(dtype, b))
        if dtype == torch.bfloat16:
            ffn_pb, att_pb = PartsBound(), PartsBound()
            fe._ffn_bwd(*ffn, eps, False, *map(ffn_pb.wrap, (fe.rms_norm_rows, fe.gemm, fe.gemm_bwd, fe.rms_norm_bwd)))
            fe._attn_bwd(*att, H, eps, *map(att_pb.wrap, (fe.rms_norm_rows, fe.gemm, fa.flash_attention_fwd,
                                                          fa.flash_attention_bwd, fe.gemm_bwd, fe.rms_norm_bwd)))
            checks.timed("t5_ffn_bwd", f"B8 T512 t5-base {tag}", lambda: fe.t5_ffn_bwd(*ffn, eps=eps, gated=False),
                         lambda: fe.t5_ffn_bwd_reference(*ffn, eps=eps, gated=False), iters=5, parts_bound=ffn_pb)
            checks.timed("t5_attn_bwd", f"B8 T512 t5-base {tag}", lambda: fe.t5_attn_bwd(*att, num_heads=H, eps=eps),
                         lambda: fe.t5_attn_bwd_reference(*att, num_heads=H, eps=eps), iters=5, parts_bound=att_pb)

    # the whole layer, f32 with an f32 bias: T5LayerTrain against autograd
    l = {k: v.detach().float().requires_grad_() for k, v in layer.items()}
    b32 = bias.float().requires_grad_()
    x = randn(B, T, d).requires_grad_()
    cot = randn(B, T, d)
    kw = dict(num_heads=H, eps=eps, gated=False)
    ins = [x, b32] + [l[k] for k in fe.layer_keys(False)]
    got = torch.autograd.grad(fe.t5_layer_train(x, mask, b32, l, **kw), ins, cot)
    with torch.no_grad():
        _, x1 = fe.fused_t5_layer_parts(x, mask, b32, l, **kw, save_x1=True)
    relu = MaskedRelu(kernel_relu_masks([x1], [l["ln1"]], [l["wi"]], eps))
    ref = fe._t5_layer(x, mask, b32, l, H, eps, False, rms_norm, relu.gemm, fa.flash_attention_reference)
    want = torch.autograd.grad(ref, ins, cot)
    log(f"  ReLU signs where the plain f32 GEMM and the kernel differ, whole layer: {relu.flips}")
    for name, a, b in zip(["x", "bias", *fe.layer_keys(False)], got, want):
        checks.compare("t5_layer_train", f"B8 T512 t5-base f32 d{name}", a, b, rel_tol(torch.float32, b))


def check_encoder_grad(g: torch.Generator) -> float:
    """6c: the full-width f32 12-layer encoder gradient through the kernels
    against autograd of the plain stack; returns the worst error relative
    to each gradient's largest value."""
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models.layers import rms_norm
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    cfg = t5m.T5Config(num_decoder_layers=1)
    params = t5m.init_t5_params(g, cfg)
    enc = params.encoder
    enc.requires_grad_(True)
    B, T = 2, 512
    x = torch.randn((B, T, cfg.d_model), generator=g, device=dev).requires_grad_()
    cot = torch.randn((B, T, cfg.d_model), generator=g, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < torch.tensor([512, 300], device=dev)[:, None]
    names = ["x"] + [n for n, _ in enc.named_parameters()]
    ins = [x] + list(enc.parameters())
    t0 = time.perf_counter()
    got = torch.autograd.grad(t5m.encode(params, cfg, x, mask, train=True), ins, cot)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3

    pos = torch.arange(T)
    bias = t5m.relative_bias(enc.rel_bias, pos, pos, True, cfg)[0].to(torch.bfloat16).contiguous()
    layers = fe.fuse_t5_blocks(enc.layers, False)
    kw = dict(num_heads=cfg.num_heads, eps=cfg.layer_norm_eps, gated=False)
    x1s, h = [], x.detach()
    with torch.no_grad():  # the kernels' forward, for their ReLU decisions
        for l in layers:
            h, x1 = fe.fused_t5_layer_parts(h, mask, bias.detach(), l, **kw, save_x1=True)
            x1s.append(x1)
    relu = MaskedRelu(kernel_relu_masks(x1s, [l["ln1"] for l in layers], [l["wi"] for l in layers],
                                        cfg.layer_norm_eps))
    del x1s
    h = x
    for l in layers:
        h = fe._t5_layer(h, mask, bias, l, cfg.num_heads, cfg.layer_norm_eps, False, rms_norm, relu.gemm,
                         fa.flash_attention_reference)
    want = torch.autograd.grad(rms_norm(h, enc.final_ln, cfg.layer_norm_eps), ins, cot)
    log(f"  ReLU signs where the plain f32 GEMM and the kernels differ, 12 layers: {relu.flips}")
    worst, worst_name = 0.0, ""
    for name, a, b in zip(names, got, want):
        rel = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        # the rel-pos table's gradient comes through the bf16 bias in both
        limit = BF16_REL_TOL if name == "rel_bias" else F32_TOL
        if not (math.isfinite(rel) and rel <= limit):
            raise AssertionError(f"encoder gradient {name}: {rel:.3e} of its largest value, above {limit}")
        if name != "rel_bias" and rel > worst:
            worst, worst_name = rel, name
    log(f"  encoder gradient f32 t5-base B2 T512 (12 layers) kernels vs autograd of the plain stack: worst "
        f"{worst:.3e} of the largest value ({worst_name}; limit {F32_TOL:.0e}), {ms:.1f} ms forward+backward")
    return worst


def train(g: torch.Generator, steps: int = 8):
    """6d: t5-base VT5 train steps on one repeated batch, bf16 compute."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps, to_device
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
    from rag_docvqa_tpu_torch.training.train_step import TrainState, make_train_step
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    dev = g.device
    # configs/RAGVT5.yml: t5-base widths, chunk_num 10, chunk_size 60,
    # overlap 10, max_source_length 512, lr 2e-4, batch_size 8
    ingestor = DocVQAIngestor(HashTokenizer(32128), ChunkSpec(chunk_size=60, overlap=10), Caps())
    docs = make_corpus(8, n_pages=8, words_per_page=120, seed=SEED)
    ingestor.caps = ingestor.plan_caps(docs)
    batch, aux = ingestor.ingest(docs)
    batch = to_device(batch, dev)
    labels = torch.from_numpy(ingestor.answer_labels(aux["answers"], max_len=32, seed=SEED)).to(dev)
    vt5_cfg = vt5m.VT5Config()
    params = vt5m.init_vt5_params(g, vt5_cfg)  # f32 masters
    rag = RAGConfig(page_retrieval="concat", chunk_num=10, include_surroundings=0, max_source_length=512)
    # one batch an epoch for the yml's 10 epochs; warmup 2 steps, not 1000
    opt = build_optimizer(lr=2e-4, warmup_steps=2, total_steps=10 * steps,
                          mask=trainable_mask(params, ("t5", "spatial")))
    state = TrainState.create(params, opt)
    step = make_train_step(vt5_cfg, rag, opt, bf16_compute=True)

    kernels.reset_launch_counts()
    rows = []
    for i in range(steps):
        ev = {n: torch.cuda.Event(enable_timing=True) for n in ("start", "forward", "backward", "update")}
        t0 = time.perf_counter()
        ev["start"].record()
        state, m = step(state, batch, labels, mark=lambda n: ev[n].record())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        row = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "wall_ms": wall,
               "forward_ms": ev["start"].elapsed_time(ev["forward"]),
               "backward_ms": ev["forward"].elapsed_time(ev["backward"]),
               "update_ms": ev["backward"].elapsed_time(ev["update"])}
        rows.append(row)
        log(f"  step {i + 1}: loss {row['loss']:.4f}, grad norm {row['grad_norm']:.4f}, {wall:.1f} ms "
            f"(forward {row['forward_ms']:.1f}, backward {row['backward_ms']:.1f}, update {row['update_ms']:.1f})")
    launches = dict(kernels.LAUNCHES)
    log(f"  launches in the {steps} train steps: {launches}")
    check_launched(launches, TRAIN_KERNELS, "training")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows):
        raise AssertionError("non-finite loss or grad norm")
    if not rows[-1]["loss"] < rows[0]["loss"]:
        raise AssertionError(f"the loss did not fall on the repeated batch: {[r['loss'] for r in rows]}")
    steady = rows[1:]  # the first step also warms the allocator
    mean = lambda k: sum(r[k] for r in steady) / len(steady)
    summary = {"ms": mean("wall_ms"), "forward_ms": mean("forward_ms"), "backward_ms": mean("backward_ms"),
               "update_ms": mean("update_ms"), "losses": [r["loss"] for r in rows],
               "case": f"t5-base VT5 B8 T512 bf16 compute, mean of steps 2-{steps}"}
    log(f"  mean of steps 2-{steps}: {summary['ms']:.1f} ms per step (forward {summary['forward_ms']:.1f}, "
        f"backward {summary['backward_ms']:.1f}, update {summary['update_ms']:.1f})")
    return launches, summary

# --------------------------------------------------------------------------- #
# phase 7: the corpus index
# --------------------------------------------------------------------------- #
INDEX_N, INDEX_D, INDEX_B, INDEX_K = 524288, 768, 256, 10  # the path's shape


TOPK_KERNEL_NAMES = ("fused_topk_f32_kernel", "fused_topk_bf16_kernel", "topk_merge_kernel", "segmax_f32_kernel",
                     "segmax_bf16_kernel", "segmax_int8_kernel", "segmax_int4_kernel", "supermax_kernel")
MAXSIM_KERNEL_NAMES = ("maxsim_wgmma_kernel", "strip_sum_kernel")


def check_route(call, want: set, what: str, names=TOPK_KERNEL_NAMES, stems=("topk", "segmax")) -> None:
    """Fails unless the kernels of csrc/topk_*.cu (or of the source whose
    kernel `names` and name `stems` are given) that one call enqueues (the
    nodes of the CUDA graph captured from it, by kernel name) are exactly
    `want`."""
    got = set()
    for node in graph_nodes(call):
        name = next((n for n in names if n in node), None)
        if name is not None:
            got.add(name)
        elif any(s in node for s in stems):
            got.add(node)
    log(f"  {what}: its {stems[0]} kernels {sorted(got)}")
    if got != want:
        raise AssertionError(f"{what} launched the {stems[0]} kernels {sorted(got)}, not {sorted(want)}")


def check_index_kernels(checks: Checks, g: torch.Generator) -> dict:
    """7a: K4, K5, K11 and K12 against their plain versions; returns the
    whole-function times on both sides of the batch crossover, the sweeps of
    the tile plans (`ops/topk.py::_tile_plan`), the blocks an SM holds of each
    kernel's forms and, per float case, K4's value error and its share of
    indices equal to the plain version's."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.kernels import DTYPE_CODES
    from rag_docvqa_tpu_torch.ops import quant, topk

    check_hgmma("topk_fused.cu", need=(("fused_topk_f32_kernel", "HGMMA"), ("fused_topk_bf16_kernel", "HGMMA")))
    check_hgmma("topk_segmax.cu", need=(("segmax_f32_kernel", "HGMMA"), ("segmax_bf16_kernel", "HGMMA"),
                                        ("segmax_int8_kernel", "IGMMA"), ("segmax_int4_kernel", "IGMMA")),
                forbid=(("segmax_int8_kernel", "IDP.4A"), ("segmax_int4_kernel", "IDP.4A")))
    dev = g.device
    whole = {"k4_against_plain": {}}

    def sweep(label, plans, calls):
        """Device ms of each call under each (B, query tile, row-block count)
        plan, set by hand over the rule of ops/topk.py (`_tile_plan`)."""
        runs, rule = {}, topk._tile_plan
        try:
            for b, tq, counts in plans:
                for n_rb in counts:
                    topk._tile_plan = lambda *_, plan=(tq, n_rb): plan
                    runs[f"B{b} tq{tq} n_rb {n_rb}"] = {name: device_ms(lambda: fn(b)) for name, fn in calls.items()}
        finally:
            topk._tile_plan = rule
        log(f"  {label} by query tile and row-block count (device ms): {runs}")
        return runs

    def rule_plans(entry, n_rows, batches, *args):
        """What the rule gives at each batch size, from the kernel's occupancy."""
        return {b: topk.kernel_plan(dev, n_rows, b, entry, *args) for b in batches}

    # the blocks an SM holds of each form of each wgmma top-k kernel, as the runtime reports them
    residency = {f"{entry} {args}": {tq: kernels.resident(entry, dev, tq, *args) for tq in topk._QUERY_TILES}
                 for entry, args in (("topk_fused_resident", (DTYPE_CODES[torch.float32], 10)),
                                     ("topk_fused_resident", (DTYPE_CODES[torch.bfloat16], 10)),
                                     ("topk_segmax_resident", (DTYPE_CODES[torch.float32],)),
                                     ("topk_segmax_resident", (DTYPE_CODES[torch.bfloat16],)),
                                     ("topk_segmax_int8_resident", (16,)),
                                     ("topk_segmax_int8_resident", (8,)),
                                     ("topk_segmax_int4_resident", (16,)),
                                     ("topk_segmax_int4_resident", (8,)))}
    log(f"  blocks an SM holds, by query tile (runtime occupancy): {residency}")
    whole["resident_blocks"] = residency

    def case(N, n_valid, D, B, k, label, dups=(), timed=False, int_kernels=True, dtypes=("f32", "bf16")):
        x = torch.randn((N, D), generator=g, device=dev)
        for src, dst in dups:
            x[dst] = x[src]
        x = topk.l2_normalize(x)
        x[n_valid:] = 0.0
        q = torch.randn((B, D), generator=g, device=dev)
        if dups:
            q[0] = x[dups[0][0]]
        q = topk.l2_normalize(q)
        valid_rows = torch.arange(N, device=dev)[None, :] < n_valid
        flops = 2.0 * N * D * B

        for tag in dtypes:
            index = x if tag == "f32" else x.bfloat16()
            name = f"{label} {tag}"
            # the f32 index's six exact products are held tighter than F32_TOL
            limit = F32_TILE_TOL if tag == "f32" else F32_TOL
            scores = torch.where(valid_rows, q @ index.float().t(), topk.NEG_INF)  # the plain (B, N) matrix
            # ---- K4
            vals, idx = topk.fused_topk(index, q, n_valid, k)
            want_v, want_i = topk.fused_topk_reference(index, q, n_valid, k)
            err_v = checks.compare("topk_fused", f"{name} values", vals, want_v, limit)
            live = want_v > topk.NEG_INF / 2
            if not bool(((idx >= 0) & (idx < max(n_valid, 1)))[live].all()):
                raise AssertionError(f"topk_fused {name}: an index outside the valid rows")
            srt = torch.sort(torch.where(live, idx, -1 - torch.arange(k, device=dev)[None, :].expand_as(idx)), dim=1)[0]
            if bool((srt[:, 1:] == srt[:, :-1]).any()):
                raise AssertionError(f"topk_fused {name}: a row returned twice")
            checks.compare("topk_fused", f"{name} scores at returned rows",
                           torch.where(live, scores.gather(1, idx.long()), vals), vals, limit)
            same = (idx == want_i)[live].float().mean().item() if bool(live.any()) else 1.0
            log(f"  {'topk_fused':24s} {name:44s} indices equal to the plain version's: {same:.6f}")
            whole["k4_against_plain"][name] = {"values_max_abs_err": err_v, "indices_equal_share": same}
            if tag == "f32" and N == INDEX_N and not same >= 0.999:
                raise AssertionError(f"topk_fused {name}: only {same} of the indices equal the plain version's")
            # ---- K5
            for group, sgroups in ((8, 16), (16, 1)):
                seg, sup = topk.segment_max(index, q, n_valid, group, sgroups)
                want_seg, want_sup = topk.segment_max_reference(index, q, n_valid, group, sgroups)
                checks.compare("topk_segmax", f"{name} g{group} sg{sgroups} maxima", seg, want_seg, limit)
                if sgroups > 1:
                    checks.compare("topk_segmax", f"{name} g{group} sg{sgroups} supermaxima", sup, want_sup, limit)
            # the whole two-phase function: its values are exact scores of the rows it returns
            tv, ti, tok = topk.cosine_topk_twophase(index, q, n_valid, k, tile_n=512 if N % 2048 else 2048)
            checks.compare("topk_segmax", f"{name} two-phase values", tv, want_v, limit)
            checks.compare("topk_segmax", f"{name} two-phase scores at returned rows",
                           torch.where(tok, scores.gather(1, ti.long()), tv), tv, limit)
            if not timed and B == 3:  # the kernels one call runs, from its captured graph
                k4, k5 = (("fused_topk_f32_kernel", "segmax_f32_kernel") if tag == "f32"
                          else ("fused_topk_bf16_kernel", "segmax_bf16_kernel"))
                check_route(lambda: topk.fused_topk(index, q, n_valid, k), {k4, "topk_merge_kernel"}, f"K4 {name}")
                check_route(lambda: topk.segment_max(index, q, n_valid, 8, 16), {k5, "supermax_kernel"}, f"K5 {name}")
            if timed:
                elt = index.element_size()
                qd = q.to(index.dtype)
                # torch.backends.cuda.matmul.allow_tf32 is False (phase 1): a strict f32 product on an f32 index
                library = lambda: torch.matmul(qd, index.t()).topk(k)  # its tie order is not the contract
                # both tiles read the query as three bf16 terms; the bf16 tile makes three products of each
                # index element, the f32 tile six (its rows split into three terms)
                q_in, terms = topk.split_bf16x3(q), (6 if tag == "f32" else 3)
                label4, label5 = f"N{N} D{D} B{B} k{k} {tag}", f"N{N} D{D} B{B} g8 sg16 {tag}"
                io4 = n_valid * D * elt + nbytes(q_in, vals, idx)
                checks.timed("topk_fused", label4, lambda: topk.fused_topk(index, q, n_valid, k),
                             lambda: topk.fused_topk_reference(index, q, n_valid, k), library=library,
                             io_bytes=io4, ops=terms * 2.0 * n_valid * D * B, ops_in="bf16", device=True)
                seg, sup = topk.segment_max(index, q, n_valid, 8, 16)
                io5 = nbytes(index, q_in, seg, sup)
                checks.timed("topk_segmax", label5, lambda: topk.segment_max(index, q, n_valid, 8, 16),
                             lambda: topk.segment_max_reference(index, q, n_valid, 8, 16), library=library,
                             io_bytes=io5, ops=terms * flops, ops_in="bf16", device=True)
                if tag == "f32":  # the bound of the SIMT f32 tile the wgmma tile replaced, for the record
                    log(f"  the SIMT f32 tile's bound (ms): K4 {label4} {bound(io4, 2.0 * n_valid * D * B, 'f32')[0]}, "
                        f"K5 {label5} {bound(io5, flops, 'f32')[0]}")
                whole[f"B{B} {tag}"] = {
                    "fused_ms": time_ms(lambda: topk.cosine_topk_fused(index, q, n_valid, k)),
                    "twophase_ms": time_ms(lambda: topk.cosine_topk_twophase(index, q, n_valid, k)),
                    "matmul_topk_ms": checks.times["topk_fused"][label4]["library_ms"]}
                log(f"  whole functions at {name}: {whole[f'B{B} {tag}']}")
                if B == INDEX_B:  # the batch sweep across the crossover, on the same index
                    batches = {}
                    for b in (8, 16, 32, 64, 256):
                        qb = q[:b]
                        batches[b] = {"k4_ms": time_ms(lambda: topk.fused_topk(index, qb, n_valid, k)),
                                      "fused_ms": time_ms(lambda: topk.cosine_topk_fused(index, qb, n_valid, k)),
                                      "twophase_ms": time_ms(lambda: topk.cosine_topk_twophase(index, qb, n_valid, k))}
                    whole[f"sweep {tag}"] = batches
                    log(f"  K4 and the whole functions by batch at N{N} D{D} k{k} {tag}: {batches}")
                    plans = {"f32": ((8, 8, (132, 264, 396, 528)), (256, 128, (66, 132, 198)), (256, 64, (33, 66, 132))),
                             "bf16": ((8, 8, (264, 396, 586, 792)), (256, 64, (66, 99, 133, 198)))}[tag]
                    code = DTYPE_CODES[index.dtype]
                    rules = {"k4": rule_plans("topk_fused_resident", N, (8, 256), code, k),
                             "k5": rule_plans("topk_segmax_resident", N, (8, 256), code)}
                    whole[f"row blocks {tag}"] = sweep(
                        f"K4 and K5 at N{N} D{D} {tag} (the rule's (query tile, row blocks): {rules})", plans,
                        {"k4_ms": lambda b: topk.fused_topk(index, q[:b], n_valid, k),
                         "k5_ms": lambda b: topk.segment_max(index, q[:b], n_valid, 8, 16)})
            del scores, index
        if not int_kernels:
            return
        # ---- K11, K12: exact
        q8, _ = quant.quantize_rows(q)
        for unit, build, segmax, segmax_ref, two, flat in (
                ("topk_segmax_int8", quant.quantize_rows, quant.segment_max_int8, quant.segment_max_int8_reference,
                 quant.cosine_topk_int8_twophase, quant.cosine_topk_int8),
                ("topk_segmax_int4", quant.quantize_rows_int4, quant.segment_max_int4,
                 quant.segment_max_int4_reference, quant.cosine_topk_int4_twophase, quant.cosine_topk_int4)):
            rows, scale = build(x)
            got = segmax(rows, scale, q8, n_valid, 16)
            checks.compare(unit, f"{label} g16 maxima (exact)", got, segmax_ref(rows, scale, q8, n_valid, 16), 0.0)
            if not timed:  # every other group the kernels take, each on its own path through K12's epilogue
                for group in (1, 2, 8, 32, 128):
                    checks.compare(unit, f"{label} g{group} maxima (exact)", segmax(rows, scale, q8, n_valid, group),
                                   segmax_ref(rows, scale, q8, n_valid, group), 0.0)
            if not timed and B == 20:  # the int8 or int4 tile kernel, and nothing else
                kern = "segmax_int8_kernel" if unit == "topk_segmax_int8" else "segmax_int4_kernel"
                check_route(lambda: segmax(rows, scale, q8, n_valid, 16), {kern}, f"{unit} {label}")
            gv, gi, gok = two(rows, scale, q, n_valid, k, tile_n=512 if N % 2048 else 2048)
            wv, wi, wok = flat(rows, scale, q, n_valid, k)
            checks.compare(unit, f"{label} two-phase values against flat (exact)", gv, wv, 0.0)
            if not (torch.equal(gi[wok], wi[wok]) and torch.equal(gok, wok)):
                raise AssertionError(f"{unit} {label}: two-phase indices differ from the flat function's")
            if timed:
                checks.timed(unit, f"N{N} D{D} B{B} g16", lambda: segmax(rows, scale, q8, n_valid, 16),
                             lambda: segmax_ref(rows, scale, q8, n_valid, 16),
                             io_bytes=nbytes(rows, scale, q8, got), ops=flops, ops_in="int8", device=True)
                if B > 16:  # no one call computes the maxima; for scale, the int8 product of the unpacked operands
                    unpacked = rows if unit == "topk_segmax_int8" else torch.cat(quant.unpack_int4(rows), dim=1)
                    int_mm = lambda: torch._int_mm(q8, unpacked.t())
                    extra = {"int_mm_ms": time_ms(int_mm), "int_mm_device_ms": device_ms(int_mm)}
                    checks.times[unit][f"N{N} D{D} B{B} g16"].update(extra)
                    log(f"  {unit:24s} torch._int_mm of the unpacked operands alone (no scale, no maxima): {extra}")
                    del unpacked
                whole.setdefault(f"B{B} {unit[12:]}", {})["twophase_ms"] = time_ms(
                    lambda: two(rows, scale, q, n_valid, k))
                # both integer tiles' plans, K11 on I8Tile as K12 on I4Tile
                kname = "K11" if unit == "topk_segmax_int8" else "K12"
                plans = ((8, 8, (132, 264, 396)),) if B <= 16 else ((B, 128, (132, 264)), (B, 64, (66, 132)))
                rule = rule_plans(f"{unit}_resident", N, (8 if B <= 16 else B,), 16)
                whole[f"tile plans {unit[12:]} B{B}"] = sweep(
                    f"{kname} at N{N} D{D} B{B} (the rule's (query tile, row blocks): {rule})", plans,
                    {f"{kname.lower()}_ms": lambda b: segmax(rows, scale, q8[:b], n_valid, 16)})
            del rows, scale

    dups = ((3, 7), (3, 130), (3, 1029))
    for B in (3, 20, 130):
        case(1536, 1100, 64, B, 5, f"ragged N1536 valid1100 D64 B{B} k5", dups)
    case(1536, 0, 64, 20, 5, "ragged N1536 valid0 D64 B20 k5")
    case(1536, 1100, 32, 20, 5, "ragged N1536 valid1100 D32 B20 k5", dups, dtypes=())
    case(1024, 1024, 32, 40, 48, "N1024 D32 B40 k48", dups[:2], int_kernels=False)
    N, D, k = INDEX_N, INDEX_D, INDEX_K
    case(N, N, D, INDEX_B, k, f"N{N} D{D} B{INDEX_B} k{k}", timed=True)
    torch.cuda.empty_cache()
    case(N, N, D, 8, k, f"N{N} D{D} B8 k{k}", timed=True)
    torch.cuda.empty_cache()
    return whole


def agreement(idx, want) -> float:
    """Mean share of each query's top-k rows that the reference also holds."""
    idx, want = torch.as_tensor(idx).cpu().long(), want.cpu().long()
    return (idx[:, :, None] == want[:, None, :]).any(dim=2).float().mean().item()


def refined_pipeline(index, batches) -> dict:
    """`refined_query_batches` over a few B 256 batches against the serial
    `cosine_topk_int4_refined` on each: equal results, and ms per batch of
    both on the host's clock (the pipelined one rescores batch i on the host
    while the device shortlists batch i+1)."""
    import numpy as np

    from rag_docvqa_tpu_torch.ops import quant

    k, kprime = INDEX_K, index.refine_kprime
    pairs = [(b, b.cpu().numpy()) for b in batches]
    common = dict(host_rows=index.host_rows, kprime=kprime, rows_normalized=True)

    def serial():
        return [quant.cosine_topk_int4_refined(index.embeddings, index.scales, b, index.n_valid, k, **common)
                for b, _ in pairs]

    def piped():
        return list(quant.refined_query_batches(index.embeddings, index.scales, pairs, index.n_valid, k, **common))

    want, got = serial(), piped()
    if len(got) != len(want):
        raise AssertionError(f"refined_query_batches gave {len(got)} results for {len(want)} batches")
    for i, (w, p) in enumerate(zip(want, got)):
        if not all(np.array_equal(a, b) for a, b in zip(w, p)):
            raise AssertionError(f"refined_query_batches: batch {i} differs from the serial refined query")
    times = {}
    for name, fn in (("serial", serial), ("pipelined", piped), ("pipelined", piped), ("serial", serial)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) / len(pairs) * 1e3)
    res = {"refined_serial_ms_per_batch": min(times["serial"]), "refined_pipelined_ms_per_batch": min(times["pipelined"])}
    log(f"  refined_query_batches over {len(pairs)} batches of {len(batches[0])}: equal to the serial refined query; "
        f"ms per batch serial {times['serial']}, pipelined {times['pipelined']}")
    return res


def index_path(g: torch.Generator) -> dict:
    """7b: build and query the resident index in every precision, as 1 and
    as 4 row ranges."""
    from rag_docvqa_tpu_torch.ops import topk
    from rag_docvqa_tpu_torch.parallel import ShardedIndex, single_device_query

    dev = g.device
    N, D, B, k = INDEX_N, INDEX_D, INDEX_B, INDEX_K
    emb = torch.randn((N, D), generator=g, device=dev)  # raw rows, as ShardedIndex.build takes them
    queries = torch.randn((B, D), generator=g, device=dev)
    want_v, want_i, _ = single_device_query(emb, queries, k)  # the plain f32 query
    scores = topk.l2_normalize(queries) @ topk.l2_normalize(emb).t()
    out = {}
    for dtype, refine in (("f32", False), ("bf16", False), ("int8", False), ("int4", False), ("int4", True)):
        name = dtype + ("_refine" if refine else "")
        results = {}
        for n_shards in (1, 4):
            t0 = time.perf_counter()
            index = ShardedIndex.build(emb, n_shards=n_shards, dtype=dtype, refine=refine, kernel="auto")
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            results[n_shards] = tuple(torch.as_tensor(a).to(dev) for a in index.query(queries, k))
        for a, b in zip(results[1], results[4]):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: 1 and 4 row ranges give different results")
        vals, idx, valid = results[1]
        if not (bool(valid.all()) and bool(torch.isfinite(vals).all()) and vals.shape == (B, k)):
            raise AssertionError(f"{name}: bad values or validity")
        agree = agreement(idx, want_i)
        if dtype == "f32":
            err_v = (vals - want_v).abs().max().item()
            err_s = (scores.gather(1, idx.long()) - vals).abs().max().item()
            if not (err_v <= F32_TOL and err_s <= F32_TOL):
                raise AssertionError(f"f32 index: values off the plain query by {err_v}, from their rows' scores by {err_s}")
            log(f"  f32 index against the plain query: values max_abs_err {err_v:.3e}, returned rows' scores {err_s:.3e}")
        # queries per second at B 256, the host rescore included where there is one
        index.query(queries, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            index.query(queries, k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        small = None
        if dtype in ("f32", "bf16"):  # at B 8 the dispatch takes the running-merge kernel
            sv = index.query(queries[:8], k)[0]
            if not (sv - vals[:8]).abs().max().item() <= F32_TOL:
                raise AssertionError(f"{name}: B 8 and B 256 disagree on the same queries")
            small = time_ms(lambda: index.query(queries[:8], k))
        out[name] = {"top10_agreement_with_f32": agree, "resident_bytes": index.resident_bytes, "build_s": build_s,
                     "query_ms_b256": ms, "queries_per_s_b256": B / ms * 1e3, "query_ms_b8": small}
        log(f"  {name:12s} resident {index.resident_bytes / 1e6:8.1f} MB, build {build_s:.2f} s, top-{k} agreement "
            f"with f32 {agree:.4f}, B{B} query {ms:.3f} ms = {B / ms * 1e3:.0f} queries/s"
            + ("" if small is None else f", B8 query {small:.3f} ms") + "; 1 and 4 row ranges identical")
        if refine:
            out[name].update(refined_pipeline(index, [torch.randn((B, D), generator=g, device=dev) for _ in range(4)]))
        del index
    if not out["f32"]["top10_agreement_with_f32"] >= 0.999:
        raise AssertionError("the f32 index disagrees with the plain f32 query")
    if not (out["int8"]["top10_agreement_with_f32"] >= 0.9 and out["int4_refine"]["top10_agreement_with_f32"] >= 0.95):
        raise AssertionError(f"agreement below the limits (int8 0.9, refined int4 0.95): {out}")
    return out


def index_cli() -> dict:
    """7c: `precompute index` then `precompute query`, the entry points."""
    import argparse
    import contextlib
    import io
    import tempfile

    import numpy as np

    from rag_docvqa_tpu_torch import precompute
    from rag_docvqa_tpu_torch.parallel import single_device_query

    model, dataset = os.path.join(REPO, "configs", "RAGVT5.yml"), os.path.join(REPO, "configs", "Synthetic.yml")
    question, k = "what is the invoice total?", 5

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            precompute.main(argv)
        return buf.getvalue().strip().splitlines()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus_index.npz")
        info = json.loads(run(["index", "-m", model, "-d", dataset, "--out", path, "n_val_docs=256", "n_pages=8",
                               "words_per_page=120"])[-1])
        log(f"  precompute index: {info}")
        data = np.load(path, allow_pickle=True)
        emb, meta = data["embeddings"], json.loads(str(data["meta"]))
        if not (emb.shape == (info["n_chunks"], 768) and len(meta) == len(emb) > 2048 and np.isfinite(emb).all()):
            raise AssertionError(f"bad index file: embeddings {emb.shape}, {len(meta)} meta rows")
        ranks = {}
        for dtype, refine in (("f32", False), ("bf16", False), ("int8", False), ("int4", False), ("int8", True),
                              ("int4", True)):
            rows = [json.loads(l) for l in run(["query", "--index", path, "-m", model, "-q", question, "--k", str(k),
                                                "--index-dtype", dtype] + (["--refine"] if refine else []))]
            name = dtype + ("_refine" if refine else "")
            if [r["rank"] for r in rows] != list(range(k)) or not all(
                    math.isfinite(r["score"]) and {"question_id", "doc_idx", "page", "text"} <= set(r) for r in rows):
                raise AssertionError(f"precompute query {name}: bad rank lines {rows}")
            ranks[name] = [{f: r[f] for f in ("question_id", "doc_idx", "page", "text")} for r in rows]
        # the f32 ranks are those of the plain unsharded query with the same weights
        device, _, tokenizer, _, params = precompute._setup(argparse.Namespace(device="cuda", model=model, overrides=[]))
        with torch.inference_mode():
            q = precompute.embed_question(params.t5.shared, tokenizer, question, device)
            _, idx, _ = single_device_query(torch.from_numpy(emb).to(device), q, k)
        if ranks["f32"] != [meta[int(i)] for i in idx[0]]:
            raise AssertionError("precompute query f32: ranks differ from single_device_query")
        same = {name: sum(a == b for a, b in zip(r, ranks["f32"])) for name, r in ranks.items()}
        log(f"  precompute query, {len(emb)} chunks: every rank line parses; f32 ranks are single_device_query's; "
            f"ranks of {k} equal to f32's: {same}")
    return {"n_chunks": info["n_chunks"], "chunks_per_sec": info["chunks_per_sec"], "ranks_equal_to_f32_of_5": same}


# --------------------------------------------------------------------------- #
# phase 8: the BERT family
# --------------------------------------------------------------------------- #
BGE = dict(vocab_size=30522, hidden_size=384, num_layers=12, num_heads=12, intermediate_size=1536)  # bge-small
# the XLM-R-base cross-encoder width; the vocabulary is the engine tokenizer's
XLMR = dict(hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072, max_position_embeddings=514,
            type_vocab_size=1, position_offset=2, pad_id=1, num_labels=1)
# (tag, B, T, d, heads, d_ff): the shapes paths 1 and 2 give the layer
BERT_SHAPES = (("bge-small B1024 T64", 1024, 64, 384, 12, 1536), ("xlmr-base B320 T192", 320, 192, 768, 12, 3072))
EMBED_N, EMBED_B, BERT_T = 16384, 1024, 64  # path 1: chunks, chunks per batch, tokens per chunk
CONTRASTIVE_B = 256  # path 3: pairs per step


def random_bert_layer(g: torch.Generator, d: int, dff: int) -> dict:
    """One layer in the kernels' form with weights of unit-variance outputs,
    random biases and LayerNorm pairs (f32)."""
    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    ln = lambda: torch.stack([torch.rand(d, generator=g, device=dev) + 0.5, randn(d) * 0.1])
    return {"wqkv": randn(3 * d, d) * d**-0.5, "bqkv": randn(3 * d) * 0.1, "wo": randn(d, d) * d**-0.5,
            "bo": randn(d) * 0.1, "ln1": ln(), "w1": randn(dff, d) * d**-0.5, "b1": randn(dff) * 0.1,
            "w2": randn(d, dff) * dff**-0.5, "b2": randn(d) * 0.1, "ln2": ln()}


def ragged_mask(B: int, T: int, dev) -> torch.Tensor:
    """Lengths from T down to 1 over the batch."""
    lens = torch.tensor([max(1, T - (i * 7) % T) for i in range(B)], device=dev)
    return torch.arange(T, device=dev)[None, :] < lens[:, None]


def check_bert_kernels(checks: Checks, g: torch.Generator) -> None:
    """8a: K9's parts and the whole layer against their plain versions."""
    import torch.nn.functional as F

    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        timed = dtype == torch.bfloat16
        gemm_cases = [((77, 100, 72, "bias"), "ragged 77x100x72 bias"),
                      ((77, 96, 64, "bias_gelu"), "ragged 77x96x64 bias_gelu"),
                      ((77, 96, 64, "bias_residual_f32"), "ragged 77x96x64 bias_residual_f32")]
        for _, B, T, d, _, dff in BERT_SHAPES:
            R = B * T
            gemm_cases += [((R, 3 * d, d, "bias"), f"qkv {R}x{3 * d}x{d} bias"),
                           ((R, dff, d, "bias_gelu"), f"fc1 {R}x{dff}x{d} bias_gelu"),
                           ((R, d, dff, "bias_residual_f32"), f"fc2 {R}x{d}x{dff} bias_residual_f32")]
        for (M, N, K, epi), label in gemm_cases:
            a, w, bias = randn(M, K).to(dtype), (randn(N, K) * K**-0.5).to(dtype), (randn(N) * 0.5).to(dtype)
            aux = randn(M, N).to(dtype) if epi == "bias_residual_f32" else None
            got, want = fe.gemm(a, w, epi, aux, bias), fe.gemm_reference(a, w, epi, aux, bias)
            checks.compare("bert_gemm", f"{label} {tag}", got, want, tol(dtype, want))
            if timed and M > 77:
                library = (lambda: torch.addmm(bias, a, w.t())) if epi == "bias" else None  # the others: no single call
                checks.timed("bert_gemm", f"{label} {tag}", lambda: fe.gemm(a, w, epi, aux, bias),
                             lambda: fe.gemm_reference(a, w, epi, aux, bias), library=library,
                             io_bytes=nbytes(a, w, bias, aux, got), ops=2.0 * M * N * K, ops_in=op_type(dtype),
                             device=True)
            del a, w, aux, got, want
        for R, d in [(77, 64)] + [(B * T, d) for _, B, T, d, _, _ in BERT_SHAPES]:
            y, ln = randn(R, d) * 3.0 + 0.5, torch.stack([torch.rand(d, generator=g, device=dev) + 0.5, randn(d)]).to(dtype)
            y[0] = 2.0  # a constant row: variance 0 under eps 1e-12
            got, want = fe.layer_norm_rows(y, ln, 1e-12, dtype), fe.layer_norm_reference(y, ln, 1e-12, dtype)
            checks.compare("bert_layer_norm", f"{R}x{d} {tag}", got, want, tol(dtype, want))
            if timed and R > 77:
                w32, b32 = ln[0].float(), ln[1].float()
                checks.timed("bert_layer_norm", f"{R}x{d} {tag}", lambda: fe.layer_norm_rows(y, ln, 1e-12, dtype),
                             lambda: fe.layer_norm_reference(y, ln, 1e-12, dtype),
                             library=lambda: F.layer_norm(y, (d,), w32, b32, 1e-12).to(dtype),
                             io_bytes=nbytes(y, ln, got), ops=8.0 * R * d, device=True)
        # K2 at the BERT shapes: no bias, scale dh^-0.5, mask value -1e30
        for label, B, T, d, H, _ in BERT_SHAPES:
            dh = d // H
            qkv = randn(B, T, 3, H, dh).to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            mask = ragged_mask(B, T, dev)
            args = (mask, None, dh**-0.5, False, fe.BERT_MASK_VALUE)
            (got, glse), (want, wlse) = fa.flash_attention_fwd(q, k, v, *args), fa.flash_attention_reference(q, k, v, *args)
            checks.compare("flash_fwd", f"{label} dh{dh} no bias {tag} out", got, want, tol(dtype, want))
            checks.compare("flash_fwd", f"{label} dh{dh} no bias {tag} lse", glse, wlse, tol(dtype, wlse))
            if timed:
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                pad = mask[:, None, None, :]
                checks.timed("flash_fwd", f"{label} dh{dh} no bias {tag}", lambda: fa.flash_attention_fwd(q, k, v, *args),
                             lambda: fa.flash_attention_reference(q, k, v, *args),
                             library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=pad, scale=dh**-0.5),
                             io_bytes=nbytes(qkv, mask, got, glse), ops=4.0 * B * H * T * T * dh, ops_in=op_type(dtype))
            del qkv, got, want

    # the whole layer: the small ragged case with one sequence of no valid key, then both path shapes
    small = random_bert_layer(g, 64, 128)
    lens = torch.tensor([24, 17, 9, 3, 1, 24, 0], device=dev)
    mask = torch.arange(24, device=dev)[None, :] < lens[:, None]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        l = {k: v.to(dtype) for k, v in small.items()}
        x = randn(7, 24, 64).to(dtype)
        got = fe.fused_bert_layer_parts(x, mask, l, num_heads=4, eps=1e-12, save_x1=True)
        want = fe.bert_layer_reference(x, mask, l, num_heads=4, eps=1e-12, save_x1=True)
        for name, a, b in zip(("out", "x1"), got, want):  # compare also fails on a non-finite value
            checks.compare("bert_layer", f"ragged B7 T24 d64, one row without keys {tag} {name}", a, b, tol(dtype, b))
        for label, B, T, d, H, dff in BERT_SHAPES:
            l = {k: v.to(dtype) for k, v in random_bert_layer(g, d, dff).items()}
            x, m = randn(B, T, d).to(dtype), ragged_mask(B, T, dev)
            kw = dict(num_heads=H, eps=1e-12)
            out = fe.fused_bert_layer_parts(x, m, l, **kw)
            got = fe.fused_bert_layer_parts(x, m, l, **kw, save_x1=True)
            want = fe.bert_layer_reference(x, m, l, **kw, save_x1=True)
            if not torch.equal(out, got[0]):
                raise AssertionError(f"bert_layer {label} {tag}: save_x1 changes the output")
            for name, a, b in zip(("out", "x1"), got, want):
                checks.compare("bert_layer", f"{label} {tag} {name}", a, b, tol(dtype, b))
            if dtype == torch.bfloat16:
                pb = PartsBound()
                fe._bert_layer(x, m, l, H, 1e-12, *map(pb.wrap, (fe.gemm, fe.layer_norm_rows, fa.flash_attention_fwd)))
                checks.timed("bert_layer", f"{label} {tag}", lambda: fe.fused_bert_layer_parts(x, m, l, **kw),
                             lambda: fe.bert_layer_reference(x, m, l, **kw), iters=5, parts_bound=pb)
            del l, x, out, got, want
    torch.cuda.empty_cache()


def plain_bert_stack(params, cfg, ids, mask):
    """`bert_encode` from the plain layer only."""
    from rag_docvqa_tpu_torch.models import bert
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    x = bert.bert_embed(params, cfg, ids, mask)
    for l in fe.fuse_bert_blocks(params.layers):
        x = fe.bert_layer_reference(x, mask, l, num_heads=cfg.num_heads, eps=cfg.layer_norm_eps)
    return x


def bert_tokens(g: torch.Generator, n: int, T: int, vocab: int, empty_every: int = 0):
    """Synthetic chunks: random ids, lengths 8..T, and every `empty_every`-th
    row a padded slot with no valid token."""
    dev = g.device
    ids = torch.randint(0, vocab, (n, T), generator=g, device=dev)
    lens = torch.randint(8, T + 1, (n,), generator=g, device=dev)
    if empty_every:
        lens[empty_every - 1::empty_every] = 0
    return ids, torch.arange(T, device=dev)[None, :] < lens[:, None]


def check_bert_stack(g: torch.Generator) -> None:
    """8b: the full-width f32 bge-small encoder against the plain stack."""
    from rag_docvqa_tpu_torch.models import bert

    cfg = bert.BertConfig(**BGE)
    params = bert.init_bert_params(g, cfg)
    ids, mask = bert_tokens(g, 64, 64, cfg.vocab_size)
    t0 = time.perf_counter()
    got = bert.bert_encode(params, cfg, ids, mask)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = plain_bert_stack(params, cfg, ids, mask)
    err = (got - want).abs().max().item()
    log(f"  bert_encode f32 bge-small B64 T64 (12 layers) kernels vs plain stack: max_abs_err {err:.3e} "
        f"(limit {F32_TOL:.0e}), max|ref| {want.abs().max().item():.3g}, {ms:.1f} ms")
    if not (math.isfinite(err) and err <= F32_TOL):
        raise AssertionError(f"full-width bert_encode differs from the plain stack by {err}")


def embed_index_path(g: torch.Generator):
    """8c, path 1: embed synthetic chunks with the bge-small bi-encoder in
    bf16, build the bf16 index, query it."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.models import bert
    from rag_docvqa_tpu_torch.models.embedder import embed_batch
    from rag_docvqa_tpu_torch.ops import topk
    from rag_docvqa_tpu_torch.parallel import ShardedIndex

    N, B, T, NQ, k = EMBED_N, EMBED_B, BERT_T, 64, 10
    cfg = bert.BertConfig(**BGE)
    params = bert.init_bert_params(g, cfg).to(torch.bfloat16)
    ids, mask = bert_tokens(g, N, T, cfg.vocab_size, empty_every=97)  # padded slots among the chunks
    q_ids, q_mask = bert_tokens(g, NQ, T, cfg.vocab_size)
    embed_batch(params, "BGE", ids[:B], mask[:B], cfg)  # warmup, not counted
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    emb = torch.cat([embed_batch(params, "BGE", ids[i:i + B], mask[i:i + B], cfg) for i in range(0, N, B)])
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    index = ShardedIndex.build(emb.float(), dtype="bf16", kernel="auto")
    queries = embed_batch(params, "BGE", q_ids, q_mask, cfg).float()
    vals, idx, valid = (torch.as_tensor(a).to(g.device) for a in index.query(queries, k))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    norms = torch.linalg.vector_norm(emb.float(), dim=-1)
    if not (emb.shape == (N, cfg.hidden_size) and bool(torch.isfinite(emb.float()).all())
            and (norms - 1.0).abs().max().item() <= 2e-2):
        raise AssertionError(f"bad embeddings: shape {tuple(emb.shape)}, norms {norms.min().item()}..{norms.max().item()}")
    # every returned value is the score of its row in the plain product over the resident rows
    scores = topk.l2_normalize(queries) @ index.embeddings.float()[:N].t()
    err = (scores.gather(1, idx.long()) - vals).abs().max().item()
    best = (scores.max(dim=1).values - vals[:, 0]).abs().max().item()
    if not (bool(valid.all()) and vals.shape == (NQ, k) and err <= 1e-3 and best <= 1e-3):
        raise AssertionError(f"index query over the embeddings: returned rows' scores off by {err}, best score by {best}")
    log(f"  embedded {N} chunks (T {T}, bf16, batches of {B}, {int((~mask.any(dim=1)).sum())} padded slots: finite) "
        f"in {embed_s * 1e3:.1f} ms = {N / embed_s:.0f} chunks/s; bf16 index built; {NQ} queries k {k}: returned rows' "
        f"scores within {err:.2e}, best score within {best:.2e} of the plain product")
    log(f"  launches in the embed -> index path: {launches}")
    check_launched(launches, EMBED_KERNELS, "embed -> index")
    if launches["topk_fused"] + launches["topk_segmax"] <= 0:
        raise AssertionError("the index query launched no top-k kernel")
    return launches, {"chunks": N, "batch": B, "T": T, "embed_ms": embed_s * 1e3, "chunks_per_s": N / embed_s,
                      "ms_per_batch": embed_s * 1e3 / (N // B)}


def serve_reranked(g: torch.Generator):
    """8d, path 2: RAGVT5Engine.inference with the cross-encoder reranker."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
    from rag_docvqa_tpu_torch.engine.reranker import Reranker, RerankerConfig
    from rag_docvqa_tpu_torch.models import bert
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    tok = HashTokenizer(32128)
    ingestor = DocVQAIngestor(tok, ChunkSpec(chunk_size=60, overlap=10), Caps())
    docs = make_corpus(96, n_pages=8, words_per_page=120, seed=SEED + 1)
    ingestor.caps = ingestor.plan_caps(docs)
    batches = [ingestor.ingest(docs[i:i + 32]) for i in range(0, 96, 32)]
    vt5_cfg = vt5m.VT5Config(t5=t5m.T5Config(decode_kv_int8=True, fused_decode_attn=True))
    params = vt5m.init_vt5_params(g, vt5_cfg).to(torch.bfloat16)
    bert_cfg = bert.BertConfig(vocab_size=tok.vocab_size, **XLMR)
    rcfg = RerankerConfig()  # thresh 0.4, at most 5, at least 1, pair_len 192
    reranker = Reranker(rcfg, bert_cfg, bert.init_bert_params(g, bert_cfg).to(torch.bfloat16))
    engine = RAGVT5Engine(RAGConfig(page_retrieval="concat", chunk_num=10, include_surroundings=0,
                                    max_source_length=512, max_new_tokens=16), vt5_cfg, params, tok, reranker=reranker)
    engine.inference(*batches[0])  # warmup, not counted
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    results = []
    for batch, aux in batches[1:]:
        t0 = time.perf_counter()
        out = engine.inference(batch, aux)
        results.append((out, (time.perf_counter() - t0) * 1e3))
    launches = dict(kernels.LAUNCHES)

    rows = []
    for i, (out, wall) in enumerate(results):
        conf, sims = out["confidences"], torch.as_tensor(out["retrieval"]["similarities"])
        if len(out["pred_answers"]) != 32 or not all(math.isfinite(c) and 0.0 < c <= 1.0 + 1e-6 for c in conf):
            raise AssertionError(f"reranked batch {i}: bad answers or confidences {conf}")
        for b, pages in enumerate(out["pred_answer_pages"]):
            n, s = len(pages), sims[b]
            if not (rcfg.min_chunk_num <= n <= rcfg.max_chunk_num and bool(torch.isfinite(s[:n]).all())
                    and bool((s[:n - 1] >= s[1:n]).all()) and bool((s[:n] >= 0).all()) and bool((s[:n] <= 1).all())):
                raise AssertionError(f"reranked batch {i} doc {b}: {n} valid ranks with scores {s.tolist()}")
        t = out["timings"]
        rerank_ms = out["retrieval"]["rerank_time"] * 1e3
        rows.append({"wall_ms": wall, "rerank_ms": rerank_ms})
        kept = [len(p) for p in out["pred_answer_pages"]]
        log(f"  batch {i}: {wall:.1f} ms wall; retrieve+rerank+assemble {t['retrieve_assemble_s'] * 1e3:.2f} ms of which "
            f"the reranker (320 pairs x T192, 12 layers) {rerank_ms:.2f} ms, encode {t['encode_s'] * 1e3:.2f} ms, "
            f"decode {t['decode_s'] * 1e3:.2f} ms; ranks kept per document {min(kept)}..{max(kept)}, scores sorted")
    log(f"  launches in the two reranked batches: {launches}")
    check_launched(launches, SERVE_KERNELS + EMBED_KERNELS, "reranked serving")
    return launches, {"ms_per_batch": sum(r["wall_ms"] for r in rows) / len(rows),
                      "rerank_ms_per_batch": sum(r["rerank_ms"] for r in rows) / len(rows), "batches": rows}


def check_bert_bwd(checks: Checks, g: torch.Generator) -> float:
    """8e: K10's parts and halves against their plain versions, the whole
    layer and the full-width encoder gradient against autograd of the plain
    stack; returns the encoder gradient's worst relative error."""
    from rag_docvqa_tpu_torch.models import bert
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    # bge-small at the contrastive step's shape
    B, T, d, H, dff, eps = CONTRASTIVE_B, BERT_T, BGE["hidden_size"], BGE["num_heads"], BGE["intermediate_size"], 1e-12
    R = B * T
    check_hgmma("bert_layer_bwd.cu")
    check_gemm_bwd_edges(checks, g, bert=True)
    check_col_sum_edges(checks, dev)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        timed = dtype == torch.bfloat16
        for (layout, epi, M, N, K), label in (
                (("nt", "bias_gelu_grad", 77, 96, 64), "ragged nt bias_gelu_grad 77x96x64"),
                (("nn", "mul_f32", 77, 96, 64), "ragged nn mul_f32 77x96x64"),
                (("nn", "add_f32_store", 77, 96, 64), "ragged nn add_f32_store 77x96x64"),
                (("nt", "bias_gelu_grad", R, dff, d), f"nt bias_gelu_grad {R}x{dff}x{d}"),
                (("nn", "mul_f32", R, dff, d), f"nn mul_f32 {R}x{dff}x{d}"),
                (("nn", "add_f32_store", R, d, dff), f"nn add_f32_store {R}x{d}x{dff}")):
            path = timed and M > 77
            gemm_bwd_case(checks, g, layout, epi, M, N, K, dtype, f"{label} {tag}", twice=path, timed=path)
        # the weight-gradient products at this shape: few output tiles, so the rows are cut into ranges
        for M, N, label in ((dff, d, "dW1"), (d, d, "dWo")):
            a, b = randn(R, M).to(dtype), randn(R, N).to(dtype)
            got, want = fe.gemm_bwd(a, b, "tn", "store_f32"), fe.gemm_bwd_reference(a, b, "tn", "store_f32")
            label = f"tn {label} {M}x{N} over {R} rows in {fe.tn_splits(M, N, R, timed)} ranges {tag}"
            checks.compare("t5_gemm_bwd", label, got, want, rel_tol(dtype, want))
            if timed:
                if not torch.equal(got, fe.gemm_bwd(a, b, "tn", "store_f32")):
                    raise AssertionError(f"t5_gemm_bwd {label}: a second launch on the same input gave other bits")
                checks.timed("t5_gemm_bwd", label, lambda: fe.gemm_bwd(a, b, "tn", "store_f32"),
                             lambda: fe.gemm_bwd_reference(a, b, "tn", "store_f32"),
                             library=lambda: torch.matmul(a.t(), b), library_is="torch.matmul, bf16 out",
                             io_bytes=nbytes(a, b, got), ops=2.0 * M * N * R, ops_in=op_type(dtype), device=True)
            del a, b, got, want
        for rows in (77, R):
            y, gg = randn(rows, d) * 3.0 + 0.5, randn(rows, d).to(dtype)
            ln = torch.stack([torch.rand(d, generator=g, device=dev) + 0.5, randn(d)]).to(dtype)
            got, want = fe.layer_norm_bwd(y, gg, ln, eps), fe.layer_norm_bwd_reference(y, gg, ln, eps)
            for name, x, w in zip(("dy", "dy cast", "dln", "dsum"), got, want):
                limit = tol(dtype, w) if name.startswith("dy") else rel_tol(dtype, w)
                checks.compare("bert_ln_bwd", f"{rows}x{d} {tag} {name}", x, w, limit)
            if timed and rows == R:
                w32, b32 = ln[0].float(), ln[1].float()

                def library():  # autograd of the one library LayerNorm call
                    yy = y.detach().requires_grad_()
                    return torch.autograd.grad(torch.nn.functional.layer_norm(yy, (d,), w32, b32, eps), yy, gg.float())

                again = fe.layer_norm_bwd(y, gg, ln, eps)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"bert_ln_bwd {rows}x{d} {tag}: a second launch on the same input gave other bits")
                checks.timed("bert_ln_bwd", f"{rows}x{d} {tag}", lambda: fe.layer_norm_bwd(y, gg, ln, eps),
                             lambda: fe.layer_norm_bwd_reference(y, gg, ln, eps), library=library,
                             library_is="autograd of F.layer_norm in f32: dy, dw, db",
                             io_bytes=nbytes(y, gg, ln, *got), ops=16.0 * rows * d, device=True)
        for rows, n, in_dtype in ((77, 100, dtype), (R, dff, torch.float32), (R, 3 * d, dtype)):
            x = randn(rows, n).to(in_dtype)
            got, want = fe.col_sum(x), fe.col_sum_reference(x)
            label = f"{rows}x{n} {op_type(in_dtype)}"
            checks.compare("bert_col_sum", label, got, want, rel_tol(in_dtype, want))
            if timed and rows == R:
                if not torch.equal(got, fe.col_sum(x)):
                    raise AssertionError(f"bert_col_sum {label}: a second launch on the same input gave other bits")
                checks.timed("bert_col_sum", label, lambda: fe.col_sum(x), lambda: fe.col_sum_reference(x),
                             library=lambda: x.sum(dim=0, dtype=torch.float32), library_is="x.sum(0, dtype=f32)",
                             io_bytes=nbytes(x, got), ops=1.0 * rows * n, device=True)

        # the two halves at the step's shape
        l = {k: v.to(dtype) for k, v in random_bert_layer(g, d, dff).items()}
        x, x1, dy = randn(B, T, d).to(dtype), randn(B, T, d).to(dtype), randn(B, T, d).to(dtype)
        mask = ragged_mask(B, T, dev)
        ffn = (x1, dy, l["ln2"], l["w1"], l["b1"], l["w2"], l["b2"])
        got, want = fe.bert_ffn_bwd(*ffn, eps=eps), fe.bert_ffn_bwd_reference(*ffn, eps=eps)
        for name, a, b in zip(("dx1", "dln2", "dw1", "db1", "dw2", "db2"), got, want):
            checks.compare("bert_ffn_bwd", f"bge-small B{B} T{T} {tag} {name}", a, b, rel_tol(dtype, b))
        att = (x, dy, mask, l["wqkv"], l["bqkv"], l["wo"], l["bo"], l["ln1"])
        got, want = fe.bert_attn_bwd(*att, num_heads=H, eps=eps), fe.bert_attn_bwd_reference(*att, num_heads=H, eps=eps)
        for name, a, b in zip(("dx", "dln1", "dwqkv", "dbqkv", "dwo", "dbo"), got, want):
            checks.compare("bert_attn_bwd", f"bge-small B{B} T{T} {tag} {name}", a, b, rel_tol(dtype, b))
        if timed:
            ffn_pb, att_pb = PartsBound(), PartsBound()
            fe._bert_ffn_bwd(*ffn, eps, *map(ffn_pb.wrap, (fe.gemm, fe.gemm_bwd, fe.layer_norm_bwd, fe.col_sum)))
            fe._bert_attn_bwd(*att, H, eps, *map(att_pb.wrap, (fe.gemm, fa.flash_attention_fwd, fa.flash_attention_bwd,
                                                               fe.gemm_bwd, fe.layer_norm_bwd, fe.col_sum)))
            checks.timed("bert_ffn_bwd", f"bge-small B{B} T{T} {tag}", lambda: fe.bert_ffn_bwd(*ffn, eps=eps),
                         lambda: fe.bert_ffn_bwd_reference(*ffn, eps=eps), iters=5, parts_bound=ffn_pb)
            checks.timed("bert_attn_bwd", f"bge-small B{B} T{T} {tag}", lambda: fe.bert_attn_bwd(*att, num_heads=H, eps=eps),
                         lambda: fe.bert_attn_bwd_reference(*att, num_heads=H, eps=eps), iters=5, parts_bound=att_pb)
        del l, x, x1, dy, got, want
    torch.cuda.empty_cache()

    # a sequence with no valid key: a finite output cotangent gives finite gradients, zero through its attention
    l = random_bert_layer(g, 64, 128)
    lens = torch.tensor([24, 17, 0, 3], device=dev)
    m = torch.arange(24, device=dev)[None, :] < lens[:, None]
    att = (randn(4, 24, 64), randn(4, 24, 64), m, l["wqkv"], l["bqkv"], l["wo"], l["bo"], l["ln1"])
    got, want = fe.bert_attn_bwd(*att, num_heads=4, eps=eps), fe.bert_attn_bwd_reference(*att, num_heads=4, eps=eps)
    for name, a, b in zip(("dx", "dln1", "dwqkv", "dbqkv", "dwo", "dbo"), got, want):  # fails on a non-finite value
        checks.compare("bert_attn_bwd", f"ragged B4 T24 d64, one row without keys f32 {name}", a, b,
                       rel_tol(torch.float32, b))

    # the whole layer, f32: BertLayerTrain against autograd through the plain layer
    l = {k: v.requires_grad_() for k, v in random_bert_layer(g, d, dff).items()}
    x, cot, mask = randn(B, T, d).requires_grad_(), randn(B, T, d), ragged_mask(B, T, dev)
    ins = [x] + [l[k] for k in fe.BERT_KEYS]
    got = torch.autograd.grad(fe.bert_layer_train(x, mask, l, num_heads=H, eps=eps), ins, cot)
    want = torch.autograd.grad(fe.bert_layer_reference(x, mask, l, num_heads=H, eps=eps), ins, cot)
    for name, a, b in zip(["x", *fe.BERT_KEYS], got, want):
        checks.compare("bert_layer_train", f"bge-small B{B} T{T} f32 d{name}", a, b, rel_tol(torch.float32, b))
    del l, x, got, want
    torch.cuda.empty_cache()

    # the full-width f32 12-layer bge-small encoder gradient, B 16
    cfg = bert.BertConfig(**BGE)
    params = bert.init_bert_params(g, cfg)
    params.requires_grad_(True)
    ids, mask = bert_tokens(g, 16, T, cfg.vocab_size)
    cot = randn(16, T, d)
    names, ins = zip(*params.named_parameters())
    t0 = time.perf_counter()
    got = torch.autograd.grad(bert.bert_encode(params, cfg, ids, mask), ins, cot)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = torch.autograd.grad(plain_bert_stack(params, cfg, ids, mask), ins, cot)
    worst, worst_name = 0.0, ""
    for name, a, b in zip(names, got, want):
        if name.endswith(".k_b"):
            # a shift of every key moves each query's scores by one constant: the key bias has a zero
            # gradient in exact arithmetic and both sides hold rounding residue, held to an absolute limit
            if not (a - b).abs().max().item() <= F32_TOL:
                raise AssertionError(f"BERT encoder gradient {name}: residue {(a - b).abs().max().item():.3e}")
            continue
        rel = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        if not (math.isfinite(rel) and rel <= F32_TOL):
            raise AssertionError(f"BERT encoder gradient {name}: {rel:.3e} of its largest value, above {F32_TOL}")
        if rel > worst:
            worst, worst_name = rel, name
    log(f"  encoder gradient f32 bge-small B16 T{T} (12 layers) kernels vs autograd of the plain stack: worst "
        f"{worst:.3e} of the largest value ({worst_name}; limit {F32_TOL:.0e}), {ms:.1f} ms forward+backward")
    return worst


def contrastive_path(g: torch.Generator, steps: int = 8):
    """8f, path 3: contrastive steps of the bge-small bi-encoder on one
    repeated batch of pairs, bf16 compute on f32 masters."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.models import bert
    from rag_docvqa_tpu_torch.training.contrastive import (ContrastiveConfig, contrastive_optimizer,
                                                           make_contrastive_step)

    B, T = CONTRASTIVE_B, BERT_T
    cfg = bert.BertConfig(**BGE)
    ccfg = ContrastiveConfig(batch_size=B, max_tokens=T, bf16_compute=True)  # MNRL at scale 20, lr 2e-5
    embed = lambda p, ids, mask: bert.bert_sentence_embed(p, cfg, ids, mask)
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=g, device=g.device).item())

    def run():
        gg = torch.Generator(device=g.device).manual_seed(seed)
        params = bert.init_bert_params(gg, cfg)  # f32 masters
        a_ids, a_mask = bert_tokens(gg, B, T, cfg.vocab_size)
        p_ids, p_mask = bert_tokens(gg, B, T, cfg.vocab_size)
        opt = contrastive_optimizer(ccfg.lr)
        state = opt.init(params)
        step = make_contrastive_step(embed, opt, ccfg)
        rows = []
        for _ in range(steps):
            ev = {n: torch.cuda.Event(enable_timing=True) for n in ("start", "forward", "backward", "update")}
            t0 = time.perf_counter()
            ev["start"].record()
            loss = step(params, state, a_ids, a_mask, p_ids, p_mask, mark=lambda n: ev[n].record())
            torch.cuda.synchronize()
            rows.append({"loss": loss.item(), "wall_ms": (time.perf_counter() - t0) * 1e3,
                         "forward_ms": ev["start"].elapsed_time(ev["forward"]),
                         "backward_ms": ev["forward"].elapsed_time(ev["backward"]),
                         "update_ms": ev["backward"].elapsed_time(ev["update"])})
        return rows, (a_ids, p_ids)

    run()  # warmup, not counted; also the first of the two runs whose losses must repeat
    kernels.reset_launch_counts()
    rows, (a_ids, p_ids) = run()
    launches = dict(kernels.LAUNCHES)
    again, _ = run()
    for i, r in enumerate(rows):
        log(f"  step {i + 1}: loss {r['loss']:.6f}, {r['wall_ms']:.1f} ms (forward {r['forward_ms']:.1f}, "
            f"backward {r['backward_ms']:.1f}, update {r['update_ms']:.1f})")
    losses = [r["loss"] for r in rows]
    repeat = losses == [r["loss"] for r in again]
    log(f"  launches in the {steps} contrastive steps: {launches}")
    log(f"  the {steps} losses repeat digit for digit in a second run from the same seed: {repeat}")
    check_launched(launches, CONTRASTIVE_KERNELS, "contrastive")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite contrastive loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the contrastive loss did not fall on the repeated batch: {losses}")
    # the word-embedding gradient is a scatter of 2 x B x T rows into the table: its time alone
    table = torch.zeros((cfg.vocab_size, cfg.hidden_size), device=g.device)
    idx = torch.cat([a_ids, p_ids]).reshape(-1)
    src = torch.randn((idx.numel(), cfg.hidden_size), generator=g, device=g.device)
    scatter_ms = time_ms(lambda: table.index_put_((idx,), src, accumulate=True))
    log(f"  the word-embedding gradient's scatter alone ({idx.numel()} rows of {cfg.hidden_size} f32 into "
        f"{cfg.vocab_size}, index_put_ accumulate): {scatter_ms:.3f} ms")
    steady = rows[1:]
    mean = lambda key: sum(r[key] for r in steady) / len(steady)
    summary = {"ms": mean("wall_ms"), "forward_ms": mean("forward_ms"), "backward_ms": mean("backward_ms"),
               "update_ms": mean("update_ms"), "losses": losses, "losses_repeat": repeat,
               "word_emb_scatter_ms": scatter_ms,
               "case": f"bge-small B{B} pairs T{T} MNRL bf16 compute, mean of steps 2-{steps}"}
    log(f"  mean of steps 2-{steps}: {summary['ms']:.1f} ms per step (forward {summary['forward_ms']:.1f}, "
        f"backward {summary['backward_ms']:.1f}, update {summary['update_ms']:.1f})")
    return launches, summary


# --------------------------------------------------------------------------- #
# phase 9: the visual paths (K14, K13, K1 without a bias, K15)
# --------------------------------------------------------------------------- #
VIT_B, VIT_T, VIT_D, VIT_H, VIT_MLP = 32, 197, 768, 12, 3072  # ViT-base at 224 px, the served batch
P2S_D, P2S_H, P2S_DFF = 768, 12, 2048  # pix2struct-base vision width
VIT_KERNELS = ("vit_layer_norm", "vit_gemm", "vit_attention")  # K14
SERVE_VISUAL_KERNELS = SERVE_KERNELS + VIT_KERNELS
# both bias-free layers (K1 without a bias, K13) are t5_rms_norm, t5_gemm and K2 without a bias
TOWER_KERNELS = ("t5_rms_norm", "t5_gemm", "flash_fwd")
P2S_KERNELS = TOWER_KERNELS + ("maxsim", "decode_cross_attention")


def random_vit_layer(g: torch.Generator, d: int, dff: int, H: int, T: int, has_bias: bool, has_gamma: bool) -> dict:
    """One ViT / BEiT layer in the kernels' form (f32; the rel-pos bias bf16):
    weights of unit-variance outputs, random biases, LayerNorm pairs and, for
    BEiT, a zero key bias, a bias (H, T, Tb) (`vit_bias`) and layer-scale rows."""
    l = random_bert_layer(g, d, dff)
    if has_bias:
        l["bqkv"][d:2 * d] = 0.0
        l["bias"] = vit_bias(g, H, T)
    if has_gamma:
        l["gamma"] = torch.rand((2, d), generator=g, device=g.device) * 0.5 + 0.1
    return l


def vit_bias(g: torch.Generator, H: int, T: int) -> torch.Tensor:
    """A random rel-pos bias in the kernels' form: (H, T, Tb) bf16, its rows
    zero-padded to Tb = vit_bias_width(T), as fuse_vit_blocks builds it."""
    from rag_docvqa_tpu_torch.ops.fused_encoder import vit_bias_width

    b = torch.randn((H, T, T), generator=g, device=g.device)
    return torch.nn.functional.pad(b, (0, vit_bias_width(T) - T)).to(torch.bfloat16).contiguous()


def cast_layer(l: dict, dtype: torch.dtype) -> dict:
    return {k: (v if k == "bias" else v.to(dtype)) for k, v in l.items()}


def t5_layer_work(B: int, T: int, d: int, inner: int, dff: int, H: int, gated: bool) -> float:
    """Operations of one T5 layer: the products and the attention."""
    return 2.0 * B * T * (4 * d * inner + (3 if gated else 2) * d * dff) + 4.0 * B * H * T * T * (inner // H)


def check_vit_kernels(checks: Checks, g: torch.Generator) -> None:
    """9a: K14's parts and the whole layer against their plain versions."""
    import torch.nn.functional as F

    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    B, T, d, H, dff = VIT_B, VIT_T, VIT_D, VIT_H, VIT_MLP
    R = B * T
    check_hgmma("vit_layer.cu")
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        timed = dtype == torch.bfloat16
        for rows, width in ((77, 64), (R, d)):
            x, ln = (randn(rows, width) * 3.0 + 0.5).to(dtype), torch.stack(
                [torch.rand(width, generator=g, device=dev) + 0.5, randn(width)]).to(dtype)
            got, want = fe.vit_layer_norm_rows(x, ln, 1e-12), fe.vit_layer_norm_reference(x, ln, 1e-12)
            checks.compare("vit_layer_norm", f"{rows}x{width} {tag}", got, want, tol(dtype, want))
            if timed and rows > 77:
                checks.timed("vit_layer_norm", f"{rows}x{width} {tag}", lambda: fe.vit_layer_norm_rows(x, ln, 1e-12),
                             lambda: fe.vit_layer_norm_reference(x, ln, 1e-12),
                             library=lambda: F.layer_norm(x, (width,), ln[0], ln[1], 1e-12),
                             io_bytes=nbytes(x, ln, got), ops=8.0 * rows * width, device=True)
        for (M, N, K, epi, scaled), label in (((77, 100, 72, "bias", False), "ragged 77x100x72 bias"),
                                               ((77, 96, 64, "bias_gelu", False), "ragged 77x96x64 bias_gelu"),
                                               ((77, 96, 64, "bias_scale_residual", True), "ragged 77x96x64 bias_scale_residual"),
                                               ((77, 96, 64, "bias_scale_residual", False), "ragged 77x96x64 bias_residual"),
                                               ((R, 3 * d, d, "bias", False), f"qkv {R}x{3 * d}x{d} bias"),
                                               ((R, dff, d, "bias_gelu", False), f"fc1 {R}x{dff}x{d} bias_gelu"),
                                               ((R, d, dff, "bias_scale_residual", True), f"fc2 {R}x{d}x{dff} bias_scale_residual")):
            a, w, bias = randn(M, K).to(dtype), (randn(N, K) * K**-0.5).to(dtype), (randn(N) * 0.5).to(dtype)
            aux = randn(M, N).to(dtype) if epi == "bias_scale_residual" else None
            scale = (torch.rand(N, generator=g, device=dev) + 0.1).to(dtype) if scaled else None
            got, want = fe.vit_gemm(a, w, epi, aux, bias, scale), fe.gemm_reference(a, w, epi, aux, bias, scale)
            checks.compare("vit_gemm", f"{label} {tag}", got, want, tol(dtype, want))
            if timed and M > 77:
                library = (lambda: torch.addmm(bias, a, w.t())) if epi == "bias" else None  # the others: no single call
                checks.timed("vit_gemm", f"{label} {tag}", lambda: fe.vit_gemm(a, w, epi, aux, bias, scale),
                             lambda: fe.gemm_reference(a, w, epi, aux, bias, scale), library=library,
                             io_bytes=nbytes(a, w, bias, aux, scale, got), ops=2.0 * M * N * K, ops_in=op_type(dtype),
                             device=True)
            del a, w, aux, got, want
        # the attention: ragged small cases (dh 40 and 128, a row of no valid key, T no multiple of 4 or 8),
        # then the path's shape with and without the rel-pos bias
        for (Bc, Tc, Hc, dhc, biased, lens), label in (((3, 77, 4, 40, True, [77, 50, 0]), "ragged T77 dh40 bias"),
                                                       ((2, 21, 2, 128, False, [21, 5]), "ragged T21 dh128"),
                                                       ((B, T, H, d // H, True, None), f"B{B} H{H} T{T} dh{d // H} bias"),
                                                       ((B, T, H, d // H, False, None), f"B{B} H{H} T{T} dh{d // H}")):
            qkv = randn(Bc, Tc, 3, Hc, dhc).to(dtype)
            mask = torch.ones((Bc, Tc), dtype=torch.bool, device=dev) if lens is None else \
                torch.arange(Tc, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
            bias = vit_bias(g, Hc, Tc) if biased else None
            scale = dhc ** -0.5
            got, want = fe.vit_attention(qkv, mask, bias, scale), fe.vit_attention_reference(qkv, mask, bias, scale)
            checks.compare("vit_attention", f"{label} {tag}", got, want, tol(dtype, want))
            if timed and lens is None:
                if not torch.equal(got, fe.vit_attention(qkv, mask, bias, scale)):
                    raise AssertionError(f"vit_attention {label}: a second launch on the same input gave other bits")
                qt, kt, vt = (qkv[:, :, i].transpose(1, 2) for i in range(3))
                add = None if bias is None else bias[..., :Tc].to(dtype)[None]
                checks.timed("vit_attention", f"{label} {tag}", lambda: fe.vit_attention(qkv, mask, bias, scale),
                             lambda: fe.vit_attention_reference(qkv, mask, bias, scale),
                             library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add, scale=scale),
                             io_bytes=nbytes(qkv, mask, bias, got), ops=4.0 * Bc * Hc * Tc * Tc * dhc, ops_in=op_type(dtype),
                             device=True)
            del qkv, got, want
    # the bf16 attention at its tiles' edges: T across the 64-query tiles and the 256-key (128 at dh 128) score
    # row, up to the two-pass rows; dh 40 (a zero-padded K step) to 128; with and without the bias; one row
    # with no valid key (uniform over the T real keys) and one with a single key; each launched twice
    for Tc in (63, 64, 65, 129, 197, 256, 257, 300):
        for dhc in (40, 64, 128):
            for biased in (False, True):
                qkv = randn(3, Tc, 3, 2, dhc).bfloat16()
                mask = torch.arange(Tc, device=dev)[None, :] < torch.tensor([Tc, 1, 0], device=dev)[:, None]
                bias = vit_bias(g, 2, Tc) if biased else None
                run = lambda: fe.vit_attention(qkv, mask, bias, dhc ** -0.5)
                got, want = run(), fe.vit_attention_reference(qkv, mask, bias, dhc ** -0.5)
                label = f"edge T{Tc} dh{dhc}{' bias' if biased else ''} bf16"
                checks.compare("vit_attention", label, got, want, tol(torch.bfloat16, want))
                if not torch.equal(got, run()):
                    raise AssertionError(f"vit_attention {label}: a second launch on the same input gave other bits")

    # the whole layer, f32, small and ragged: plain ViT and BEiT (bias + layer-scale), T 197 and T 21
    for form, has_bias, has_gamma in (("vit", False, False), ("beit", True, True)):
        for Tc, lens in ((197, [197, 197, 120]), (21, [21, 13, 1])):
            l = random_vit_layer(g, 64, 128, 4, Tc, has_bias, has_gamma)
            x = randn(3, Tc, 64)
            mask = torch.arange(Tc, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
            got = fe.fused_vit_layer_parts(x, mask, l, num_heads=4, eps=1e-12)
            want = fe.vit_layer_reference(x, mask, l, num_heads=4, eps=1e-12)
            checks.compare("vit_layer", f"ragged {form} B3 T{Tc} d64 f32", got, want, F32_TOL)
    # ViT-base width, the served batch, both forms
    for form, has_bias, has_gamma in (("vit", False, False), ("beit", True, True)):
        layer = random_vit_layer(g, d, dff, H, T, has_bias, has_gamma)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            l = cast_layer(layer, dtype)
            x, mask = randn(B, T, d).to(dtype), torch.ones((B, T), dtype=torch.bool, device=dev)
            kw = dict(num_heads=H, eps=1e-12)
            got, want = fe.fused_vit_layer_parts(x, mask, l, **kw), fe.vit_layer_reference(x, mask, l, **kw)
            checks.compare("vit_layer", f"{form} B{B} T{T} ViT-base {tag}", got, want, tol(dtype, want))
            if dtype == torch.bfloat16:
                weights = [v for k, v in l.items()]
                checks.timed("vit_layer", f"{form} B{B} T{T} ViT-base {tag}", lambda: fe.fused_vit_layer_parts(x, mask, l, **kw),
                             lambda: fe.vit_layer_reference(x, mask, l, **kw), iters=5,
                             io_bytes=nbytes(x, mask, got, *weights),
                             ops=2.0 * R * (4 * d * d + 2 * d * dff) + 4.0 * B * H * T * T * (d // H), ops_in="bf16")
            del l, x, got, want
    torch.cuda.empty_cache()


def check_visual_length(checks: Checks, g: torch.Generator) -> None:
    """9a, second part: K2 and the whole K1 layer at the visual branch's
    encoder length, 512 text + 197 visual tokens = 709 (odd: no row of the
    bf16 bias is 16-byte aligned, the GEMMs' last tile is a tail), with the
    shared T5 rel-pos bias in bf16 as `encode` makes it, ragged text and
    every visual token valid, f32 and bf16."""
    import torch.nn.functional as F

    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    cfg = t5m.T5Config()
    B, T, H, dk, d = VIT_B, 512 + VIT_T, cfg.num_heads, cfg.d_kv, cfg.d_model
    params = t5m.init_t5_params(g, t5m.T5Config(num_encoder_layers=1, num_decoder_layers=1))
    layer = fe.fuse_t5_blocks(params.encoder.layers, False)[0]
    pos = torch.arange(T)
    bias = t5m.relative_bias(params.encoder.rel_bias, pos, pos, True, cfg)[0].to(torch.bfloat16).contiguous()
    lens = torch.tensor([512 - 13 * i for i in range(B)], device=dev)
    ids = torch.arange(T, device=dev)[None, :]
    mask = (ids < lens[:, None]) | (ids >= 512)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q, k, v = (randn(B, T, H, dk).to(dtype) for _ in range(3))
        q = q * dk ** -0.5  # T5 has no scale inside: scores of order one
        args = (q, k, v, mask, bias[None], 1.0, False, fe.T5_MASK_VALUE)
        (got, glse), (want, wlse) = fa.flash_attention_fwd(*args), fa.flash_attention_reference(*args)
        label = f"B{B} H{H} T{T} dk{dk} shared bf16 bias {tag}"
        checks.compare("flash_fwd", f"{label} out", got, want, tol(dtype, want))
        checks.compare("flash_fwd", f"{label} lse", glse, wlse, tol(dtype, wlse))
        if dtype == torch.bfloat16:
            add = (bias.float()[None] + torch.where(mask, 0.0, fe.T5_MASK_VALUE)[:, None, None, :]).to(dtype)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            checks.timed("flash_fwd", label, lambda: fa.flash_attention_fwd(*args),
                         lambda: fa.flash_attention_reference(*args),
                         library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add, scale=1.0),
                         io_bytes=nbytes(q, k, v, mask, bias, got, glse), ops=4.0 * B * H * T * T * dk, ops_in="bf16")
            del add
        del q, k, v, args, got, want
        l = {name: w.to(dtype) for name, w in layer.items()}
        x = randn(B, T, d).to(dtype)
        kw = dict(num_heads=H, eps=cfg.layer_norm_eps, gated=False)
        got, want = fe.fused_t5_layer_parts(x, mask, bias, l, **kw), fe.t5_layer_reference(x, mask, bias, l, **kw)
        checks.compare("t5_layer", f"B{B} T{T} t5-base {tag}", got, want, tol(dtype, want))
        if dtype == torch.bfloat16:
            checks.timed("t5_layer", f"B{B} T{T} t5-base {tag}", lambda: fe.fused_t5_layer_parts(x, mask, bias, l, **kw),
                         lambda: fe.t5_layer_reference(x, mask, bias, l, **kw), iters=5,
                         io_bytes=nbytes(x, mask, bias, got, *l.values()),
                         ops=t5_layer_work(B, T, d, cfg.inner_dim, cfg.d_ff, H, False), ops_in="bf16")
        del x, got, want
    torch.cuda.empty_cache()


def plain_vit_stack(params, cfg, pixels):
    """`vit_encode` from the plain layer only."""
    from rag_docvqa_tpu_torch.models import vit
    from rag_docvqa_tpu_torch.models.layers import dense, layer_norm
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    B = pixels.shape[0]
    x = dense(vit.extract_patches(pixels, cfg.patch_size), params.patch_w, params.patch_b)
    x = torch.cat([params.cls_token.expand(B, 1, cfg.hidden_size), x], dim=1) + params.pos_embed
    mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    for l in fe.fuse_vit_blocks(params.layers):
        x = fe.vit_layer_reference(x, mask, l, num_heads=cfg.num_heads, eps=cfg.layer_norm_eps)
    return layer_norm(x, params.final_ln_w, params.final_ln_b, cfg.layer_norm_eps)


def check_vit_stack(g: torch.Generator) -> None:
    """9b: the full-width f32 ViT-base tower against the plain stack."""
    from rag_docvqa_tpu_torch.models import vit

    cfg = vit.ViTConfig()
    params = vit.init_vit_params(g, cfg)
    for layer in params.layers:  # the init's zero biases would hide the bias epilogues
        for name in ("q_b", "k_b", "v_b", "o_b", "fc1_b", "fc2_b"):
            getattr(layer, name).normal_(0.0, 0.1, generator=g)
    pixels = torch.randn((8, cfg.image_size, cfg.image_size, 3), generator=g, device=g.device)
    t0 = time.perf_counter()
    got = vit.vit_encode(params, cfg, pixels)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = plain_vit_stack(params, cfg, pixels)
    err = (got - want).abs().max().item()
    log(f"  vit_encode f32 ViT-base B8 T{cfg.seq_len} (12 layers) kernels vs plain stack: max_abs_err {err:.3e} "
        f"(limit {F32_TOL:.0e}), max|ref| {want.abs().max().item():.3g}, {ms:.1f} ms")
    if not (got.shape == (8, cfg.seq_len, cfg.hidden_size) and math.isfinite(err) and err <= F32_TOL):
        raise AssertionError(f"full-width vit_encode differs from the plain stack by {err}")


def serve_visual(g: torch.Generator):
    """9c: RAGVT5Engine.inference, concat, with the visual branch: t5-base as
    phase 5 plus the ViT-base tower on one grid image per document."""
    import numpy as np

    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    tok = HashTokenizer(32128)
    ingestor = DocVQAIngestor(tok, ChunkSpec(chunk_size=60, overlap=10), Caps())
    docs = make_corpus(96, n_pages=8, words_per_page=120, seed=SEED + 2)
    rng = np.random.RandomState(SEED + 2)
    for doc in docs:  # page renders from the seed
        doc.images = [rng.randint(0, 255, (256, 192, 3), dtype=np.uint8) for _ in range(8)]
    ingestor.caps = ingestor.plan_caps(docs)
    batches = [ingestor.ingest(docs[i:i + 32]) for i in range(0, 96, 32)]
    vt5_cfg = vt5m.VT5Config(t5=t5m.T5Config(decode_kv_int8=True, fused_decode_attn=True), use_visual=True)
    params = vt5m.init_vt5_params(g, vt5_cfg).to(torch.bfloat16)
    engine = RAGVT5Engine(RAGConfig(page_retrieval="concat", chunk_num=10, include_surroundings=0,
                                    max_source_length=512, max_new_tokens=16, use_visual=True), vt5_cfg, params, tok)
    engine.inference(*batches[0])  # warmup, not counted
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    rows = []
    for i, (batch, aux) in enumerate(batches[1:]):
        t0 = time.perf_counter()
        out = engine.inference(batch, aux)
        wall = (time.perf_counter() - t0) * 1e3
        conf, t = out["confidences"], out["timings"]
        # a product of 15 maxima of a near-uniform softmax over 32,128 words (random weights) can
        # underflow f32 to 0: finite and inside [0, 1] is the check
        if len(out["pred_answers"]) != 32 or not all(math.isfinite(c) and 0.0 <= c <= 1.0 + 1e-6 for c in conf):
            raise AssertionError(f"visual batch {i}: bad answers or confidences {conf}")
        rows.append({"wall_ms": wall, "retrieve_assemble_ms": t["retrieve_assemble_s"] * 1e3,
                     "visual_ms": t["visual_s"] * 1e3, "encode_ms": (t["encode_s"] - t["visual_s"]) * 1e3,
                     "decode_ms": t["decode_s"] * 1e3})
        log(f"  batch {i}: {wall:.1f} ms wall; retrieve+assemble {rows[-1]['retrieve_assemble_ms']:.2f} ms, visual branch "
            f"(host crops, grid and resize, then ViT-base B32 T{VIT_T}) {rows[-1]['visual_ms']:.2f} ms, encode (Te "
            f"{512 + VIT_T}) {rows[-1]['encode_ms']:.2f} ms, decode {rows[-1]['decode_ms']:.2f} ms")
    launches = dict(kernels.LAUNCHES)
    # the tower alone, between two synchronizes, on pixels already on the card
    pixels = torch.randn((32, 224, 224, 3), generator=g, device=g.device)
    tower_ms = time_ms(lambda: vt5m.visual_features(params, vt5_cfg, pixels), iters=3, warmup=1)
    log(f"  visual_features alone (ViT-base bf16 B32, 12 layers + matcher): {tower_ms:.2f} ms")
    log(f"  launches in the two visual batches: {launches}")
    check_launched(launches, SERVE_VISUAL_KERNELS, "visual serving")
    mean = lambda key: sum(r[key] for r in rows) / len(rows)
    return launches, {"ms_per_batch": mean("wall_ms"), "retrieve_assemble_ms": mean("retrieve_assemble_ms"),
                      "visual_ms": mean("visual_ms"), "encode_ms": mean("encode_ms"), "decode_ms": mean("decode_ms"),
                      "visual_tower_ms": tower_ms,
                      "Te": 512 + VIT_T, "batches": rows}


def random_t5_layer(g: torch.Generator, d: int, inner: int, dff: int, gated: bool, dk: int) -> dict:
    """One bias-free T5 layer in the kernels' form (f32), weights of
    unit-variance outputs; the query rows carry dk^-0.5, as T5's init does,
    since the attention has no scale."""
    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    l = {"wqkv": randn(3 * inner, d) * d**-0.5, "wo": randn(d, inner) * inner**-0.5,
         "ln0": torch.rand(d, generator=g, device=dev) + 0.5, "ln1": torch.rand(d, generator=g, device=dev) + 0.5,
         "wof": randn(d, dff) * dff**-0.5}
    if gated:
        l.update(wi_0=randn(dff, d) * d**-0.5, wi_1=randn(dff, d) * d**-0.5)
    else:
        l["wi"] = randn(dff, d) * d**-0.5
    l["wqkv"][:inner] *= dk ** -0.5
    return l


def check_p2s_kernels(checks: Checks, g: torch.Generator) -> None:
    """9d: K13, K1 without a bias, K15 and K3 at the longer caches against
    their plain versions."""
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.ops import decode_attention as da
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe
    from rag_docvqa_tpu_torch.ops import late_interaction as li

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    lens_mask = lambda T, lens: torch.arange(T, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
    d, H, dff = P2S_D, P2S_H, P2S_DFF

    # K2 on every bias-free bf16 row (K13 and K1 without a bias: no bias, scale 1, mask value -1e9): ragged cases
    # (T no multiple of the 64-wide tiles, dk 16, 32, 64 and 128, a row with no valid key, a single key), then the
    # three shapes the tower gives it: the page budget's (K13) and the two of K1 without a bias, each beside SDPA
    import torch.nn.functional as F

    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    bias_free = lambda q, k, v, m: fa.flash_attention_fwd(q, k, v, m, None, 1.0, False, fe.T5_MASK_VALUE)[0]
    bias_free_plain = lambda q, k, v, m: fa.flash_attention_reference(q, k, v, m, None, 1.0, False, fe.T5_MASK_VALUE)[0]
    for Bc, T, Hc, dk, lens in ((3, 77, 4, 64, [77, 50, 0]), (2, 200, 2, 128, [200, 1]), (2, 64, 3, 32, [64, 33]),
                                (4, 77, 4, 16, [77, 58, 5, 0]),
                                (136, 128, H, d // H, [128 - (i * 5) % 128 if i % 17 else 0 for i in range(136)]),
                                (8, 1024, H, d // H, [1024, 1000, 900, 640, 512, 300, 77, 0]),
                                (8, 2048, H, d // H, [2048, 2048, 1900, 1500, 1100, 700, 64, 2048])):
        qkv = randn(Bc, T, 3, Hc, dk).to(torch.bfloat16)
        qkv[:, :, 0] *= dk ** -0.5  # no scale inside: scores of order one
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        mask = lens_mask(T, lens)
        got, want = bias_free(q, k, v, mask), bias_free_plain(q, k, v, mask)
        label = f"bias-free B{Bc} H{Hc} T{T} dk{dk} bf16"
        checks.compare("flash_fwd", label, got, want, tol(torch.bfloat16, want))
        if Bc >= 8:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            pad = torch.where(mask, 0.0, fe.T5_MASK_VALUE)[:, None, None, :].to(torch.bfloat16)
            checks.timed("flash_fwd", label, lambda: bias_free(q, k, v, mask), lambda: bias_free_plain(q, k, v, mask),
                         library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=pad, scale=1.0),
                         io_bytes=nbytes(qkv, mask, got), ops=4.0 * Bc * Hc * T * T * dk, ops_in="bf16")
        del qkv, got, want
    torch.cuda.empty_cache()
    # K13, small f32: against the plain version with the TPU kernel's tiles (TQ | T) and against K1's plain parts
    for gated, T, TQ, kc, chunk in ((True, 64, 16, 16, 0), (False, 96, 32, 64, 64), (True, 128, 128, 32, 32)):
        l = random_t5_layer(g, 64, 64, 128, gated, 16)
        x, mask = randn(4, T, 64), lens_mask(T, [T, T - 19, 5, 0])
        kw = dict(num_heads=4, eps=1e-6, gated=gated)
        got = fe.fused_t5_layer_qtiled(x, mask, l, **kw)
        want = fe.t5_layer_qtiled_reference(x, mask, l, TQ=TQ, kc=kc, ffn_chunk=chunk, **kw)
        checks.compare("t5_layer_qtiled", f"ragged T{T} TQ{TQ} kc{kc} ffn{chunk} {'gated' if gated else 'relu'} f32", got, want, F32_TOL)
        checks.compare("t5_layer_qtiled", f"ragged T{T} vs K1's plain parts f32", got,
                       fe.t5_layer_reference(x, mask, None, l, **kw), F32_TOL)
    # K13 and K1 without a bias, small bf16 (dk 16 and dk 32, T no multiple of the tiles, a row without keys):
    # on the card the same launches, each against its own plain version
    x0, mask = randn(4, 77, 128), lens_mask(77, [77, 58, 5, 0])
    for dmodel, dk in ((64, 16), (128, 32)):
        ls = cast_layer(random_t5_layer(g, dmodel, dmodel, 2 * dmodel, True, dk), torch.bfloat16)
        x = x0[:, :, :dmodel].to(torch.bfloat16).contiguous()
        kw = dict(num_heads=4, eps=1e-6, gated=True)
        got = fe.fused_t5_layer_qtiled(x, mask, ls, **kw)
        want = fe.t5_layer_qtiled_reference(x, mask, ls, TQ=77, kc=32, ffn_chunk=64, **kw)
        checks.compare("t5_layer_qtiled", f"ragged T77 d{dmodel} dk{dk}, one row without keys bf16", got, want,
                       tol(torch.bfloat16, want))
        got, want = fe.fused_t5_layer_parts(x, mask, None, ls, **kw), fe.t5_layer_reference(x, mask, None, ls, **kw)
        checks.compare("t5_layer_nobias", f"ragged T77 d{dmodel} dk{dk}, one row without keys bf16", got, want,
                       tol(torch.bfloat16, want))
    # dk 40: K2 zero-fills the head to its 64-wide tile
    x, mask = randn(2, 16, 160).to(torch.bfloat16), lens_mask(16, [16, 9])
    ls = cast_layer(random_t5_layer(g, 160, 160, 64, True, 40), torch.bfloat16)
    want = fe.t5_layer_reference(x, mask, None, ls, **kw)
    checks.compare("t5_layer_nobias", "T16 d160 dk40 bf16", fe.fused_t5_layer_parts(x, mask, None, ls, **kw), want,
                   tol(torch.bfloat16, want))
    layer = random_t5_layer(g, d, d, dff, True, d // H)
    weights = lambda l: list(l.values())
    # K13 at the page budget: B 8, T 2048
    B, T = 8, 2048
    mask = lens_mask(T, [2048, 2048, 1900, 1500, 1100, 700, 64, 2048])
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        l = cast_layer(layer, dtype)
        x = randn(B, T, d).to(dtype)
        kw = dict(num_heads=H, eps=1e-6, gated=True)
        got = fe.fused_t5_layer_qtiled(x, mask, l, **kw)
        want = fe.t5_layer_qtiled_reference(x, mask, l, TQ=512, kc=512, ffn_chunk=0, **kw)
        checks.compare("t5_layer_qtiled", f"B{B} T{T} pix2struct-base {tag}", got, want, tol(dtype, want))
        if dtype == torch.bfloat16:
            checks.timed("t5_layer_qtiled", f"B{B} T{T} pix2struct-base {tag}", lambda: fe.fused_t5_layer_qtiled(x, mask, l, **kw),
                         lambda: fe.t5_layer_qtiled_reference(x, mask, l, TQ=512, kc=512, ffn_chunk=0, **kw), iters=3,
                         io_bytes=nbytes(x, mask, got, *weights(l)), ops=t5_layer_work(B, T, d, d, dff, H, True), ops_in="bf16")
        del l, x, got, want
    torch.cuda.empty_cache()
    # K1 without a bias: the chunk budget (T 128 x the 136 patch sets of 8 documents) and the generator's
    # 1024-patch row; ragged masks and rows with no valid token (the padded chunk slots)
    for B, T, lens in ((136, 128, [128 - (i * 5) % 128 if i % 17 else 0 for i in range(136)]),
                       (8, 1024, [1024, 1000, 900, 640, 512, 300, 77, 0])):
        mask = lens_mask(T, lens)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            l = cast_layer(layer, dtype)
            x = randn(B, T, d).to(dtype)
            kw = dict(num_heads=H, eps=1e-6, gated=True)
            got = fe.fused_t5_layer_parts(x, mask, None, l, **kw)
            want = fe.t5_layer_reference(x, mask, None, l, **kw)
            checks.compare("t5_layer_nobias", f"B{B} T{T} pix2struct-base {tag}", got, want, tol(dtype, want))
            if dtype == torch.bfloat16:
                checks.timed("t5_layer_nobias", f"B{B} T{T} pix2struct-base {tag}",
                             lambda: fe.fused_t5_layer_parts(x, mask, None, l, **kw),
                             lambda: fe.t5_layer_reference(x, mask, None, l, **kw), iters=5,
                             io_bytes=nbytes(x, mask, got, *weights(l)), ops=t5_layer_work(B, T, d, d, dff, H, True),
                             ops_in="bf16")
            del l, x, got, want
    torch.cuda.empty_cache()

    # K15: small ragged cases (one query and batched, Tq and Tp no multiples of the 128-wide tiles, D no multiple
    # of 16, masks, a patch set of no valid token), then the engine's shapes
    q, p = randn(70, 40), randn(5, 77, 40)
    pm = torch.rand((5, 77), generator=g, device=dev) < 0.7
    pm[3] = False
    got, want = li.late_interaction(q, p, patch_mask=pm), li.late_interaction_reference(q, p, patch_mask=pm)
    checks.compare("maxsim", "ragged one query Tq70 N5 Tp77 D40", got, want, F32_TOL)
    if got[3].item() != 0.0:
        raise AssertionError("maxsim: a patch set with no valid token must score 0")
    checks.compare("maxsim", "ragged one query, no masks", li.late_interaction(q, p), li.late_interaction_reference(q, p), F32_TOL)
    check_route(lambda: li.late_interaction(q, p, patch_mask=pm), {"maxsim_wgmma_kernel"}, "K15 Tq70 Tp77 D40",
                MAXSIM_KERNEL_NAMES, ("maxsim", "strip_sum"))
    # more query tokens than a block takes (two strips, summed in order), patch sets of three row tiles, a query
    # tile of 8: on their own generator, so that the later phases' data do not move
    g15 = torch.Generator(device=dev).manual_seed(SEED + 15)
    for Bc, mc, Tq, Tp, dd in ((2, 3, 200, 300, 96), (1, 7, 5, 129, d)):
        q = torch.randn((Bc, Tq, dd), generator=g15, device=dev)
        p = torch.randn((Bc, mc, Tp, dd), generator=g15, device=dev)
        qm = (torch.rand((Bc, Tq), generator=g15, device=dev) < 0.8).float()
        pm = torch.rand((Bc, mc, Tp), generator=g15, device=dev) < 0.5
        pm[:, -1] = False
        got, want = li.late_interaction(q, p, qm, pm), li.late_interaction_reference(q, p, qm, pm)
        checks.compare("maxsim", f"ragged B{Bc} mc{mc} Tq{Tq} Tp{Tp} D{dd}", got, want, F32_TOL)
        if got[:, -1].abs().max().item() != 0.0:
            raise AssertionError("maxsim: a patch set with no valid token must score 0")
        check_route(lambda: li.late_interaction(q, p, qm, pm),
                    {"maxsim_wgmma_kernel", *(("strip_sum_kernel",) if Tq > 128 else ())}, f"K15 Tq{Tq} Tp{Tp}",
                    MAXSIM_KERNEL_NAMES, ("maxsim", "strip_sum"))
    for B, mc in ((8, 16), (32, 16)):
        Tq = Tp = 128
        q, p = randn(B, Tq, d), randn(B, mc, Tp, d)
        qm = (torch.arange(Tq, device=dev)[None, :] < torch.randint(1, Tq + 1, (B, 1), generator=g, device=dev)).float()
        pm = (torch.arange(Tp, device=dev)[None, None, :] < torch.randint(1, Tp + 1, (B, mc, 1), generator=g, device=dev)).float()
        pm[:, 12:] = 0.0  # padded chunk slots: no valid token
        got, want = li.late_interaction(q, p, qm, pm), li.late_interaction_reference(q, p, qm, pm)
        checks.compare("maxsim", f"B{B} mc{mc} Tq{Tq} Tp{Tp} D{d} f32", got, want, F32_TOL)
        if got[:, 12:].abs().max().item() != 0.0:
            raise AssertionError("maxsim: padded chunk slots must score 0")
        # the kernel's wrapper on rows already normalised (the TPU kernel's inputs), bound by its six bf16
        # products; then the C call alone on inputs prepared as the wrapper prepares them, and `late_interaction`,
        # the engine's call, with its f32 normalisation
        label = f"B{B} mc{mc} Tq{Tq} Tp{Tp} D{d} f32"
        qn, pn = li._normalize(q), li._normalize(p)
        io = nbytes(qn, pn, qm, pm, got)
        checks.timed("maxsim", label, lambda: li.maxsim(qn, pn, qm, pm), lambda: li.maxsim_reference(qn, pn, qm, pm),
                     io_bytes=io, ops=6 * 2.0 * B * mc * Tq * Tp * d, ops_in="bf16", device=True)
        launch, _ = li.maxsim_launch(qn, pn, qm, pm)
        whole = lambda: li.late_interaction(q, p, qm, pm)
        extra = {"kernel_device_ms": device_ms(launch), "late_interaction_ms": time_ms(whole),
                 "late_interaction_device_ms": device_ms(whole)}
        checks.times["maxsim"][label].update(extra)
        log(f"  {'maxsim':24s} {label}: the C call alone, and late_interaction with its normalisation: {extra}; "
            f"the SIMT f32 tile's bound {bound(io, 2.0 * B * mc * Tq * Tp * d, 'f32')[0]:.4f} ms")
        if B == 8:
            check_route(launch, {"maxsim_wgmma_kernel"}, f"K15 {label}", MAXSIM_KERNEL_NAMES, ("maxsim", "strip_sum"))
    # K3 over the longer caches of these paths: Te 709 (VT5 + visual tokens), 1024 and 2048, int8, each timed
    # over 12 distinct layer caches
    for Te in (709, 1024, 2048):
        B = 32 if Te == 709 else 8
        layers = [decode_inputs(g, B, H, 64, Te, torch.int8) for _ in range(12)]
        L = layers[0]
        got = da.fused_cross_attention(L["q"], L["k2"], L["v2"], L["m"], L["ks"], L["vs"])
        want = da.cross_attention_reference(L["q"], L["k2"], L["v2"], L["m"], L["ks"], L["vs"])
        checks.compare("decode_cross_attention", f"B{B} H{H} dk64 Te{Te} int8 cache", got, want, F32_TOL)
        time_decode_layers(checks, f"B{B} H{H} dk64 Te{Te} int8 cache", layers)
        del layers
    torch.cuda.empty_cache()


def check_p2s_stack(g: torch.Generator) -> None:
    """9e: the full-width f32 pix2struct-base vision tower at the chunk
    budget (K1 without a bias) and at the page budget (K13) against the
    plain stacks."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.models import pix2struct as p2s
    from rag_docvqa_tpu_torch.models.layers import dense, rms_norm
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    cfg = p2s.Pix2StructConfig()
    v = cfg.vision
    params = p2s.init_p2s_params(g, cfg)
    dev = g.device
    for B, T, lens in ((16, 128, [128 - 7 * i for i in range(16)]), (2, 2048, [2048, 1300])):
        cols = 32
        ids = torch.arange(T, device=dev)
        mask = (ids[None, :] < torch.tensor(lens, device=dev)[:, None]).float()
        patches = torch.cat([(ids // cols + 1)[None, :, None].expand(B, T, 1).float(),
                             (ids % cols + 1)[None, :, None].expand(B, T, 1).float(),
                             torch.randn((B, T, v.patch_dim), generator=g, device=dev)], dim=-1) * mask[..., None]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = p2s.vision_encode(params, cfg, patches, mask)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check_tower_route(kernels.LAUNCHES, v.num_layers, 1, f"f32 vision_encode at T {T}")
        p = params.vision
        x = dense(patches[:, :, 2:], p.patch_w, p.patch_b) + p.row_emb[patches[:, :, 0].long()] + p.col_emb[patches[:, :, 1].long()]
        for l in fe.fuse_t5_blocks(p.layers, True):
            kw = dict(num_heads=v.num_heads, eps=v.layer_norm_eps, gated=True)
            x = fe.t5_layer_qtiled_reference(x, mask.bool(), l, TQ=512, kc=512, **kw) if T > p2s.QTILED_ABOVE else \
                fe.t5_layer_reference(x, mask.bool(), None, l, **kw)
        want = rms_norm(x, p.final_ln, v.layer_norm_eps)
        valid = mask.bool()
        err = (got - want)[valid].abs().max().item()
        route = "K13" if T > p2s.QTILED_ABOVE else "K1 without a bias"
        log(f"  vision_encode f32 pix2struct-base B{B} T{T} (12 layers, {route}) kernels vs plain stack: max_abs_err "
            f"{err:.3e} (limit {F32_TOL:.0e}), max|ref| {want[valid].abs().max().item():.3g}, {ms:.1f} ms")
        if not (math.isfinite(err) and err <= F32_TOL and bool(torch.isfinite(got).all())):
            raise AssertionError(f"full-width vision_encode at T {T} differs from the plain stack by {err}")
        del x, got, want
    torch.cuda.empty_cache()


def p2s_documents(seed: int, n_docs: int, n_pages: int = 4, size: int = 512):
    """Synthetic page renders from a seed: noise with dark text-like bars, so
    that the horizontal strips of a page differ."""
    import numpy as np

    from rag_docvqa_tpu_torch.data.contract import RawDocument

    rng = np.random.RandomState(seed)
    docs = []
    for i in range(n_docs):
        pages = []
        for _ in range(n_pages):
            page = rng.randint(200, 256, (size, size, 3)).astype(np.uint8)
            for y in rng.randint(8, size - 8, 24):
                x0 = rng.randint(0, size // 2)
                page[y:y + 4, x0:x0 + rng.randint(16, size // 2)] = rng.randint(0, 80)
            pages.append(page)
        docs.append(RawDocument(question=f"what is the total of invoice {seed}-{i}?", words=[[]], boxes=[[]], images=pages))
    return docs


def tower_launches(params, cfg, B: int, T: int, g: torch.Generator) -> dict:
    """The launches of one `vision_encode` of B rows of T patches (random
    pixels, a 32-wide grid of ids, ragged masks), counts set to 0 just before."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.models import pix2struct as p2s

    dev = g.device
    ids = torch.arange(T, device=dev)
    mask = (ids[None, :] < torch.tensor([T - 37 * i for i in range(B)], device=dev)[:, None]).float()
    patches = torch.cat([(ids // 32 + 1)[None, :, None].expand(B, T, 1).float(),
                         (ids % 32 + 1)[None, :, None].expand(B, T, 1).float(),
                         torch.randn((B, T, cfg.vision.patch_dim), generator=g, device=dev)], dim=-1) * mask[..., None]
    kernels.reset_launch_counts()
    with torch.inference_mode():
        out = p2s.vision_encode(params, cfg, patches, mask)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"vision_encode at T {T}: non-finite values")
    return dict(kernels.LAUNCHES)


def check_tower_route(counts: dict, layers: int, encodes: int, what: str) -> None:
    """A bias-free layer is two norms, five products (qkv, O, two gated
    inputs, FFN out) and one attention, K2 without a bias, in bf16 as in
    f32. The route is read off the launch counts."""
    n = layers * encodes
    want = {"t5_rms_norm": 2 * n, "t5_gemm": 5 * n, "flash_fwd": n}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: the tower launched {got}, not {want}")


def serve_p2s(g: torch.Generator):
    """9f: RAGPix2StructEngine at pix2struct-base width with an int8 cross
    cache: inference cold and prepared, the stream, the resident index, and
    the 2048-patch budget (K13)."""
    import numpy as np

    from dataclasses import replace

    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_pix2struct import P2SRAGConfig, RAGPix2StructEngine, _score_topk
    from rag_docvqa_tpu_torch.models import pix2struct as p2s
    from rag_docvqa_tpu_torch.ops import late_interaction as li
    from rag_docvqa_tpu_torch.ops.topk import masked_topk

    base = p2s.Pix2StructConfig()
    cfg = replace(base, text=replace(base.text, decode_kv_int8=True, fused_decode_attn=True))
    params = p2s.init_p2s_params(g, cfg).to(torch.bfloat16)
    tok = HashTokenizer(cfg.text.vocab_size)
    rag = P2SRAGConfig(chunk_num=10, max_new_tokens=16)
    engine = RAGPix2StructEngine(rag, cfg, params, tok)
    if engine._xfer != np.float16:
        raise AssertionError("bf16 weights within the 2048 budget must ship f16 patches")
    B = 8
    batches = [p2s_documents(SEED + 10 + i, B) for i in range(5)]
    images = lambda docs: [[np.asarray(im) for im in d.images] for d in docs]

    def check(out, n, what):
        conf = out["confidences"]
        if len(out["pred_answers"]) != n or not all(math.isfinite(c) and 0.0 <= c <= 1.0 + 1e-6 for c in conf):
            raise AssertionError(f"{what}: bad answers or confidences {conf}")
        if not all(isinstance(p, list) and all(0 <= x < 4 for x in p) for p in out["pred_answer_pages"]):
            raise AssertionError(f"{what}: bad pages {out['pred_answer_pages']}")

    engine.inference(batches[0])  # warmup, not counted
    torch.cuda.synchronize()
    summary = {}
    L = cfg.vision.num_layers
    for T in (128, 1024, 2048):  # K1 without a bias (chunk sets, the generator's row) and K13 (the page budget)
        check_tower_route(tower_launches(params, cfg, 2, T, g), L, 1, f"bf16 vision_encode at T {T}")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cold = engine.inference(batches[1])
    cold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    prepared = engine.prepare_docs(images(batches[1]))
    prepare_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    warm = engine.inference(batches[1], prepared=prepared)
    warm_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    check(cold, B, "inference")
    check(warm, B, "prepared inference")
    if cold["pred_answers"] != warm["pred_answers"] or cold["pred_answer_pages"] != warm["pred_answer_pages"]:
        raise AssertionError("prepared documents change the answers")
    n_chunks = [p.n_chunks for p in prepared]
    log(f"  inference B{B} x 4 pages of 512x512, k 10, 1024-patch budget, 16 new tokens: cold {cold_ms:.1f} ms (host "
        f"prepare {prepare_ms:.1f} ms of it), with prepare_docs {warm_ms:.1f} ms; {min(n_chunks)}..{max(n_chunks)} chunks "
        f"per document, {B * engine._chunk_cap(n_chunks) + B} patch sets of T 128 per encode")
    log(f"  launches in the two served batches: {launches}")
    check_launched(launches, P2S_KERNELS, "RAG-Pix2Struct serving")
    # two batches of a retrieve encode (T 128) and a generator encode (T 1024) each
    check_tower_route(launches, L, 4, "two served batches")
    summary.update(cold_ms=cold_ms, prepare_ms=prepare_ms, prepared_ms=warm_ms)

    # where a prepared batch's time goes: the steps of `_dispatch_batch`, each ended by a synchronize
    from rag_docvqa_tpu_torch.ops.decode import greedy_decode
    from rag_docvqa_tpu_torch.ops.patches import pack_multi_image_patches, render_text
    t0 = time.perf_counter()
    crops, _, _, _ = engine._retrieve_batch([d.question for d in batches[1]], images(batches[1]), prepared=prepared)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    packed = [pack_multi_image_patches(c, rag.max_total_patches, normalize=True, header=render_text(d.question))
              for d, c in zip(batches[1], crops)]
    t2 = time.perf_counter()
    with torch.inference_mode():
        patches = engine._dev(np.stack([f for f, _ in packed]).astype(engine._xfer, copy=False))
        masks = engine._dev(np.stack([m for _, m in packed]))
        enc = p2s.vision_encode(params, cfg, patches, masks)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        greedy_decode(params.text, cfg.text, enc, masks.bool(), rag.max_new_tokens)
        torch.cuda.synchronize()
    t4 = time.perf_counter()
    split = {"retrieve_ms": (t1 - t0) * 1e3, "pack_ms": (t2 - t1) * 1e3, "generator_encode_ms": (t3 - t2) * 1e3,
             "decode_ms": (t4 - t3) * 1e3}
    log(f"  a prepared batch by stage: retrieve (render questions, encode 136 sets, MaxSim, top-k, merge crops) "
        f"{split['retrieve_ms']:.1f} ms, host pack of the crops {split['pack_ms']:.1f} ms, generator encode "
        f"(copy + B{B} T 1024) {split['generator_encode_ms']:.1f} ms, decode (16 steps, Te 1024) {split['decode_ms']:.1f} ms")
    summary["prepared_split"] = split

    # K15 on the engine's own embeddings, and the top-k as the index checks did: every returned value is
    # the plain score of its row, the best value is the plain best
    index8 = engine.build_visual_index(prepared)
    q_patches = np.stack([engine._render_question(d.question)[0] for d in batches[1]])
    q_mask = np.stack([engine._render_question(d.question)[1] for d in batches[1]])
    with torch.inference_mode():
        q_emb = p2s.vision_encode(params, cfg, engine._dev(q_patches), engine._dev(q_mask))
        got = li.late_interaction(q_emb, index8.emb, engine._dev(q_mask), index8.tok_mask)
        want = li.late_interaction_reference(q_emb, index8.emb, engine._dev(q_mask), index8.tok_mask)
        vals, idx, valid = _score_topk(index8.emb, index8.tok_mask, q_emb, engine._dev(q_mask), index8.chunk_valid, 10)
        plain_vals = masked_topk(want, index8.chunk_valid, 10)[0]
    err = (got - want).abs().max().item()
    at_rows = (want.gather(1, idx) - vals)[valid].abs().max().item()
    best = (plain_vals[:, 0] - vals[:, 0]).abs().max().item()
    log(f"  MaxSim on the engine's embeddings (B{B} x mc {index8.mc}, bf16 tower, f32 scores): kernel vs plain "
        f"{err:.3e}; top-10 values at the returned rows within {at_rows:.3e}, best within {best:.3e} (limit 1e-4); "
        f"scores {want[index8.chunk_valid].min().item():.3f}..{want[index8.chunk_valid].max().item():.3f}")
    if not (err <= F32_TOL and at_rows <= F32_TOL and best <= F32_TOL and bool(valid.all())):
        raise AssertionError(f"MaxSim on the engine's embeddings: {err}, {at_rows}, {best}")
    if got[~index8.chunk_valid].abs().max().item() != 0.0:
        raise AssertionError("padded chunk slots must score 0")
    summary["maxsim_err_on_engine_embeddings"] = err

    # the stream over four batches: the per-batch answers, in order
    stream_docs = batches[1:5]
    per_batch = [engine.inference(docs) for docs in stream_docs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    piped = list(engine.inference_stream(iter(stream_docs), depth=2))
    stream_ms = (time.perf_counter() - t0) * 1e3
    for i, (a, b) in enumerate(zip(piped, per_batch)):
        check(a, B, f"stream batch {i}")
        if a["pred_answers"] != b["pred_answers"] or a["pred_answer_pages"] != b["pred_answer_pages"] or \
                max(abs(x - y) for x, y in zip(a["confidences"], b["confidences"])) > 1e-3:
            raise AssertionError(f"inference_stream batch {i} differs from the per-batch call")
    log(f"  inference_stream over 4 batches of {B}: {stream_ms:.1f} ms = {stream_ms / 4:.1f} ms per batch, the same answers "
        f"and pages as per-batch calls, in order")
    summary["stream_ms_per_batch"] = stream_ms / 4

    # the resident index: 32 documents, one query each
    docs32 = [d for docs in batches[1:5] for d in docs]
    t0 = time.perf_counter()
    prepared32 = engine.prepare_docs(images(docs32))
    prep32_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    index = engine.build_visual_index(prepared32)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    questions, doc_ids = [d.question for d in docs32], list(range(32))
    engine.inference_indexed(questions, doc_ids, index)  # warmup
    # the gather of the batch's resident patch embeddings that the indexed MaxSim reads (engine/rag_pix2struct.py
    # `_indexed_retrieve_pack`), beside phase 9d's kernel time at B 32
    docs_t = torch.arange(32, device=index.emb.device)
    gather_ms = device_ms(lambda: index.emb[docs_t])
    log(f"  the indexed batch's gather index.emb[doc_ids]: {gather_ms:.4f} ms on the device for "
        f"{nbytes(index.emb[docs_t]) / 1e6:.1f} MB")
    summary["indexed_gather_device_ms"] = gather_ms
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.inference_indexed(questions, doc_ids, index)
    indexed_ms = (time.perf_counter() - t0) * 1e3
    indexed_launches = dict(kernels.LAUNCHES)
    check(out, 32, "inference_indexed")
    r = out["retrieval"]
    if not (r["chunk_indices"].shape == (32, 10) and r["valid"].all() and np.isfinite(r["similarities"]).all()
            and (np.diff(r["similarities"], axis=1) <= 1e-6).all()):
        raise AssertionError("inference_indexed: bad retrieval")
    # the host path over the same prepared documents ranks from the same embeddings
    _, _, host_vals, _ = engine._retrieve_batch(questions[:B], None, prepared=prepared32[:B])
    host_err = float(np.abs(host_vals - r["similarities"][:B]).max())
    resident = sum(t.numel() * t.element_size() for t in (index.emb, index.patches, index.tok_mask))
    log(f"  build_visual_index over 32 documents (host prepare {prep32_ms:.1f} ms, encode {build_ms:.1f} ms, "
        f"{resident / 2**20:.1f} MiB resident); inference_indexed B32: {indexed_ms:.1f} ms; top-10 scores within "
        f"{host_err:.2e} of the host path's (batch shapes differ: bf16 tower)")
    log(f"  launches in the indexed batch: {indexed_launches}")
    check_launched(indexed_launches, P2S_KERNELS, "indexed RAG-Pix2Struct serving")
    check_tower_route(indexed_launches, L, 2, "the indexed batch")  # the questions' encode and the generator's
    if host_err > 5e-2:
        raise AssertionError(f"indexed and host retrieval scores differ by {host_err}")
    summary.update(index_prepare_ms=prep32_ms, index_build_ms=build_ms, indexed_ms=indexed_ms,
                   index_resident_bytes=resident)
    del index, index8
    torch.cuda.empty_cache()

    # the 2048-patch page budget: the generator's row runs K13
    page_engine = RAGPix2StructEngine(replace(rag, max_total_patches=2048), cfg, params, tok)
    page_engine.inference(batches[0], prepared=engine.prepare_docs(images(batches[0])))  # warmup
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = page_engine.inference(batches[1], prepared=prepared)
    page_ms = (time.perf_counter() - t0) * 1e3
    page_launches = dict(kernels.LAUNCHES)
    check(out, B, "2048-patch inference")
    log(f"  inference B{B} at the 2048-patch budget (generator row T 2048 through K13, Te 2048): {page_ms:.1f} ms "
        f"with prepare_docs")
    log(f"  launches in the 2048-patch batch: {page_launches}")
    check_launched(page_launches, P2S_KERNELS, "2048-patch RAG-Pix2Struct serving")
    check_tower_route(page_launches, L, 2, "the 2048-patch batch")  # the retrieve encode and the T 2048 row
    summary["page_budget_ms"] = page_ms
    return launches, indexed_launches, page_launches, summary


# --------------------------------------------------------------------------- #
# phase 10: Hi-VT5
# --------------------------------------------------------------------------- #
# the JAX bench's Hi-VT5 row (bench.py:547-583): t5-base, 8 page slots of 10
# page tokens and 512 text tokens, B 16, 16 new tokens; half the documents
# have 3-7 pages here (the bench's all have 8), so padded page rows exist
HI_B, HI_P, HI_K, HI_T = 16, 8, 10, 512
HI_PAGES = tuple(8 if i % 2 == 0 else 3 + (i // 2) % 5 for i in range(HI_B))
HI_ROWS, HI_TE = HI_B * HI_P, HI_P * HI_K  # 128 page rows a batch; the decoder's 80 keys
HIVT5_SERVE_LAUNCHES = {"t5_rms_norm": 24, "t5_gemm": 48, "flash_fwd": 12, "decode_cross_attention": 192}


def hivt5_documents(seed: int, n_docs: int = HI_B):
    """Synthetic documents of HI_PAGES pages x 120 words, from a seed."""
    import random

    from rag_docvqa_tpu_torch.data.synthetic import make_document

    rng = random.Random(seed)
    return [make_document(rng, n_pages=HI_PAGES[i % HI_B], words_per_page=120, question_id=i) for i in range(n_docs)]


def hivt5_row_mask(g: torch.Generator, T: int, visual: bool) -> torch.Tensor:
    """(128, T) key masks as `encode_document` gives them: the 10 page tokens,
    120-450 text tokens, with `visual` the 197 visual tokens of pages with a
    render (every second page of the short documents has none), and the rows
    of a document's padded page slots with no valid key."""
    dev = g.device
    ids = torch.arange(T, device=dev)[None, :]
    text = HI_K + torch.randint(120, 451, (HI_ROWS, 1), generator=g, device=dev)
    mask = ids < text
    if visual:
        image = torch.tensor([p % 2 == 0 or HI_PAGES[b] == HI_P for b in range(HI_B) for p in range(HI_P)],
                             device=dev)[:, None]
        mask = mask | ((ids >= HI_K + HI_T) & image)
    real = torch.tensor([p < HI_PAGES[b] for b in range(HI_B) for p in range(HI_P)], device=dev)[:, None]
    return mask & real


def hivt5_small_batch(g: torch.Generator):
    """B 2 synthetic documents of 4 and 2 pages in 4 page slots of T 522 at
    t5-base, random f32 weights from `g`: (cfg, params, the batch on the
    card, 16-token answer labels)."""
    import random

    from rag_docvqa_tpu_torch.data.synthetic import make_document
    from rag_docvqa_tpu_torch.data.contract import Caps, to_device
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.models import hivt5 as hm
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    rng = random.Random(SEED + 10)
    docs = [make_document(rng, n_pages=n, words_per_page=120) for n in (4, 2)]
    ingestor = DocVQAIngestor(HashTokenizer(32128), ChunkSpec(chunk_size=60, overlap=10), Caps(max_pages=4))
    batch, aux = ingestor.ingest(docs)
    labels = torch.from_numpy(ingestor.answer_labels(aux["answers"], max_len=16, seed=SEED)).to(g.device)
    cfg = hm.HiVT5Config(max_doc_pages=4, page_tokens=HI_K, page_seq_len=HI_T)
    return cfg, hm.init_hivt5_params(g, cfg), to_device(batch, g.device), labels


def check_hivt5_encode(g: torch.Generator) -> float:
    """10a, first part: the full-width f32 `encode_document` of B 2 documents
    of 4 and 2 pages in 4 slots through the kernels against the same with the
    plain layer; F32_TOL, finite, and the padded slots' rows exactly zero."""
    from rag_docvqa_tpu_torch.models import hivt5 as hm
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    cfg, params, batch, _ = hivt5_small_batch(g)
    t0 = time.perf_counter()
    got, mask = hm.encode_document(params, cfg, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    kernel_layer = t5m.fused_t5_layer_parts
    t5m.fused_t5_layer_parts = fe.t5_layer_reference  # the same encode through the plain layer
    try:
        want, want_mask = hm.encode_document(params, cfg, batch)
    finally:
        t5m.fused_t5_layer_parts = kernel_layer
    err = (got - want).abs().max().item()
    log(f"  encode_document f32 t5-base, B2 x 4 page slots (4 and 2 pages), 8 rows of T {HI_K + HI_T}: kernels vs "
        f"plain layer max_abs_err {err:.3e} (limit {F32_TOL:.0e}), max|ref| {want.abs().max().item():.3g}, "
        f"{ms:.1f} ms")
    if not (torch.equal(mask, want_mask) and mask.sum(1).tolist() == [4 * HI_K, 2 * HI_K]):
        raise AssertionError(f"encode_document: doc_mask {mask.sum(1).tolist()}")
    if not (torch.isfinite(got).all() and err <= F32_TOL and not got[~mask].any()):
        raise AssertionError(f"encode_document: error {err}, or non-finite values, or non-zero padded rows")
    return err


def check_hivt5_kernels(checks: Checks, g: torch.Generator) -> None:
    """10a: K1 (the whole layer) and K2 at the page rows' shapes, B 128 of T
    522 (10 page tokens + 512) and T 719 (+ 197 visual tokens, valid on the
    pages with a render), bf16, rows of padded page slots with no valid key; K3 at B 16 over the 80-key document
    embedding (12 int8 and 12 bf16 caches; SDPA beside the bf16 one); K14 at
    B 128 renders of T 197. Each against its plain version, timed beside it
    and its library call, with the device time."""
    import torch.nn.functional as F

    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.ops import decode_attention as da
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    cfg = t5m.T5Config()
    params = t5m.init_t5_params(g, t5m.T5Config(num_encoder_layers=1, num_decoder_layers=1))
    layer = {k: v.bfloat16() for k, v in fe.fuse_t5_blocks(params.encoder.layers, False)[0].items()}
    kw = dict(num_heads=cfg.num_heads, eps=cfg.layer_norm_eps, gated=False)
    for T, visual in ((HI_K + HI_T, False), (HI_K + HI_T + VIT_T, True)):
        label = f"B{HI_ROWS} T{T} t5-base bf16, {HI_ROWS - sum(HI_PAGES)} rows with no valid key"
        pos = torch.arange(T)
        bias = t5m.relative_bias(params.encoder.rel_bias, pos, pos, True, cfg)[0].to(torch.bfloat16).contiguous()
        mask = hivt5_row_mask(g, T, visual)
        x = torch.randn((HI_ROWS, T, cfg.d_model), generator=g, device=dev).bfloat16()
        got, want = fe.fused_t5_layer_parts(x, mask, bias, layer, **kw), fe.t5_layer_reference(x, mask, bias, layer, **kw)
        if not torch.isfinite(got[~mask.any(1)]).all():
            raise AssertionError(f"t5_layer {label}: a row with no valid key is not finite")
        checks.compare("t5_layer", label, got, want, tol(torch.bfloat16, want))
        del got, want
        pb = PartsBound()
        fe._t5_layer(x, mask, bias, layer, cfg.num_heads, cfg.layer_norm_eps, False, pb.wrap(fe.rms_norm_rows),
                     pb.wrap(fe.gemm), pb.wrap(fa.flash_attention_fwd))
        checks.timed("t5_layer", label, lambda: fe.fused_t5_layer_parts(x, mask, bias, layer, **kw),
                     lambda: fe.t5_layer_reference(x, mask, bias, layer, **kw), iters=3, parts_bound=pb, device=True)
        del x, mask
        torch.cuda.empty_cache()
        keys = "the visual keys of pages with a render, " if visual else ""
        flash_case(checks, g, HI_ROWS, T, 12, 12, 64, torch.bfloat16, "shared", False, 1.0, fe.T5_MASK_VALUE,
                   hivt5_row_mask(g, T, visual), f"B{HI_ROWS} H12 T{T} dk64 shared bias bf16, {keys}rows with no "
                   "valid key", timed=True, device=True)
        torch.cuda.empty_cache()

    lens = [HI_K * n for n in HI_PAGES]
    for kv_dtype, tag in ((torch.int8, "int8"), (torch.bfloat16, "bf16")):
        layers = [decode_inputs(g, HI_B, 12, 64, HI_TE, kv_dtype, lens) for _ in range(12)]
        L = layers[0]
        args = (L["k2"], L["v2"], L["m"], L["ks"], L["vs"])
        for q_dtype in (torch.float32, torch.bfloat16):
            q = L["q"].to(q_dtype)
            checks.compare("decode_cross_attention", f"B{HI_B} H12 dk64 Te{HI_TE} {tag} cache, {str(q_dtype)[6:]} q",
                           da.fused_cross_attention(q, *args), da.cross_attention_reference(q, *args), F32_TOL)
        time_decode_layers(checks, f"B{HI_B} H12 dk64 Te{HI_TE} {tag} cache", layers, library=kv_dtype == torch.bfloat16)
        del layers, L, args

    # K14 at the per-page renders' batch: 16 documents x 8 page slots of 224 px
    B, T, d, H, dff = HI_ROWS, VIT_T, VIT_D, VIT_H, VIT_MLP
    l = cast_layer(random_vit_layer(g, d, dff, H, T, False, False), torch.bfloat16)
    x, mask = torch.randn((B, T, d), generator=g, device=dev).bfloat16(), torch.ones((B, T), dtype=torch.bool, device=dev)
    vkw = dict(num_heads=H, eps=1e-12)
    got, want = fe.fused_vit_layer_parts(x, mask, l, **vkw), fe.vit_layer_reference(x, mask, l, **vkw)
    label = f"vit B{B} T{T} ViT-base bf16"
    checks.compare("vit_layer", label, got, want, tol(torch.bfloat16, want))
    checks.timed("vit_layer", label, lambda: fe.fused_vit_layer_parts(x, mask, l, **vkw),
                 lambda: fe.vit_layer_reference(x, mask, l, **vkw), iters=3, device=True,
                 io_bytes=nbytes(x, mask, got, *l.values()),
                 ops=2.0 * B * T * (4 * d * d + 2 * d * dff) + 4.0 * B * H * T * T * (d // H), ops_in="bf16")
    qkv = torch.randn((B, T, 3, H, d // H), generator=g, device=dev).bfloat16()
    scale = (d // H) ** -0.5
    got, want = fe.vit_attention(qkv, mask, None, scale), fe.vit_attention_reference(qkv, mask, None, scale)
    label = f"B{B} H{H} T{T} dh{d // H} bf16"
    checks.compare("vit_attention", label, got, want, tol(torch.bfloat16, want))
    qt, kt, vt = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    checks.timed("vit_attention", label, lambda: fe.vit_attention(qkv, mask, None, scale),
                 lambda: fe.vit_attention_reference(qkv, mask, None, scale),
                 library=lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
                 io_bytes=nbytes(qkv, mask, got), ops=4.0 * B * H * T * T * (d // H), ops_in="bf16", device=True)
    del x, got, want, qkv, l
    torch.cuda.empty_cache()


def check_hivt5_train_kernels(checks: Checks, g: torch.Generator) -> None:
    """10d, first part: the training kernels at the path's shapes, B 128 page
    rows of T 522, bf16, the key masks `hivt5_row_mask` gives (rows of padded
    page slots with no valid key). K6 with the shared bf16 bias and the -1e9
    mask, timed beside SDPA's backward; K7 and K8 at t5-base
    (`layer_bwd_cases`), timed. Every gradient, those of the rows with no
    valid key included, must be finite and within `rel_tol`."""
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    T = HI_K + HI_T
    label = f"B{HI_ROWS} T{T} t5-base bf16, {HI_ROWS - sum(HI_PAGES)} rows with no valid key"
    mask = hivt5_row_mask(g, T, False)
    flash_bwd_case(checks, g, HI_ROWS, T, 12, 12, 64, torch.bfloat16, "shared", False, 1.0, fe.T5_MASK_VALUE, mask,
                   f"B{HI_ROWS} H12 T{T} dk64 shared bias t5-mask bf16, {HI_ROWS - sum(HI_PAGES)} rows with no "
                   "valid key", timed=True)
    torch.cuda.empty_cache()
    t5_base_layer_bwd(checks, g, label, HI_ROWS, T, mask, iters=3, device=False)


class KernelReluDecisions:
    """Wraps `t5_layer_train`: each call also records, in call order, the
    ReLU decisions the kernels' backward takes in that layer
    (`kernel_relu_masks` on the layer's own x1, from the same kernels'
    forward on the same input), so that the plain pass can take them."""

    def __init__(self, layer_train):
        self.layer_train, self.masks = layer_train, []

    def __call__(self, x, key_mask, bias, l, *, num_heads: int, eps: float, gated: bool):
        from rag_docvqa_tpu_torch.ops import fused_encoder as fe

        with torch.no_grad():
            ld = {k: v.detach() for k, v in l.items()}
            _, x1 = fe.fused_t5_layer_parts(x.detach().contiguous(), key_mask, bias.detach(), ld, num_heads=num_heads,
                                            eps=eps, gated=gated, save_x1=True)
            self.masks += kernel_relu_masks([x1], [ld["ln1"]], [ld["wi"]], eps)
        return self.layer_train(x, key_mask, bias, l, num_heads=num_heads, eps=eps, gated=gated)


def check_hivt5_grad(g: torch.Generator) -> dict:
    """10d, second part: the full-width f32 Hi-VT5 loss and its gradient
    (`grad_against_plain`): `forward_train` of B 2 documents of 4 and 2 pages
    in 4 slots (2 page rows with no valid key) and 16-token labels; the
    losses, and every gradient root (the T5 with both rel-pos tables, the
    spatial embeddings, `page_emb`, `page_head`)."""
    from rag_docvqa_tpu_torch.models import hivt5 as hm
    from rag_docvqa_tpu_torch.models import t5 as t5m

    cfg, params, batch, labels = hivt5_small_batch(g)

    def loss_fn(p):
        loss, parts = hm.forward_train(p, cfg, batch, labels)
        return loss, {k: parts[k] for k in ("lm_loss", "ret_loss")}

    return grad_against_plain(f"Hi-VT5 forward_train f32 t5-base, B2 x 4 page slots (4 and 2 pages)", params, loss_fn,
                              t5m, gated=False)


def hivt5_engine(g: torch.Generator, use_visual: bool):
    """`config.build_engine` -> HiVT5Engine at t5-base (the keys of
    configs/HiVT5_tiny.yml at the bench row's sizes), bf16 weights, an int8
    cross cache and K3 on (no config key sets `fused_decode_attn`: it is put
    on the built config, as phase 5 builds its T5Config)."""
    from dataclasses import replace

    from rag_docvqa_tpu_torch import config as pconfig
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.models import hivt5 as hm

    c = {"model_name": "Hi-VT5", "page_tokens": HI_K, "max_pages": HI_P, "max_text_tokens": HI_T,
         "max_new_tokens": 16, "decode_kv_int8": True, "dropout_rate": 0.0, "use_visual": use_visual}
    tok = HashTokenizer(32128)
    cfg = pconfig.build_hivt5_config(c, tok.vocab_size)
    params = hm.init_hivt5_params(g, cfg).to(torch.bfloat16)
    engine = pconfig.build_engine(c, params, tok)
    engine.cfg = replace(engine.cfg, t5=replace(engine.cfg.t5, fused_decode_attn=True))
    return engine, tok


def serve_hivt5(g: torch.Generator, use_visual: bool):
    """10b (10c with `use_visual`): three batches of 16 documents through
    `HiVT5Engine.inference`, the first a warmup; the launches of the two
    counted batches exactly HIVT5_SERVE_LAUNCHES each (with the visual
    branch also K14's); every confidence finite in [0, 1] and every page
    below its document's page count. With `use_visual`, 256 x 192 renders
    from a seed, none for the first document and every second page of the
    third, whose masks are checked; the first document's embedding must equal
    the text-only one."""
    import numpy as np

    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps, to_device
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.models import hivt5 as hm
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    engine, tok = hivt5_engine(g, use_visual)
    ingestor = DocVQAIngestor(tok, ChunkSpec(chunk_size=60, overlap=10), Caps(max_pages=HI_P))
    docs = hivt5_documents(SEED + 10 + use_visual, 3 * HI_B)
    if use_visual:
        rng = np.random.RandomState(SEED + 11)
        for i, doc in enumerate(docs):
            doc.images = [None if (i % HI_B == 2 and p % 2) else rng.randint(0, 255, (256, 192, 3), dtype=np.uint8)
                          for p in range(len(doc.words))]
            if i % HI_B == 0:
                doc.images = None
    t0 = time.perf_counter()
    batches = []
    for i in range(0, 3 * HI_B, HI_B):
        batch, aux = ingestor.ingest(docs[i:i + HI_B])
        aux["images"] = [d.images for d in docs[i:i + HI_B]]
        batches.append((batch, aux))
    log(f"  host ingest of 3 x {HI_B} docs ({min(HI_PAGES)}-{HI_P} pages x 120 words): "
        f"{time.perf_counter() - t0:.3f} s")
    engine.inference(*batches[0])  # warmup, not counted
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    results = []
    for batch, aux in batches[1:]:
        t0 = time.perf_counter()
        out = engine.inference(batch, aux)
        results.append((out, aux, (time.perf_counter() - t0) * 1e3))
    launches = dict(kernels.LAUNCHES)

    rows = []
    for i, (out, aux, wall) in enumerate(results):
        conf, t = out["confidences"], out["timings"]
        if len(out["pred_answers"]) != HI_B or not all(math.isfinite(c) and 0.0 <= c <= 1.0 + 1e-6 for c in conf):
            raise AssertionError(f"Hi-VT5 batch {i}: bad answers or confidences {conf}")
        if not all(0 <= p < n for p, n in zip(out["pred_answer_pages"], HI_PAGES)):
            raise AssertionError(f"Hi-VT5 batch {i}: a page outside its document: {out['pred_answer_pages']}")
        row = {"wall_ms": wall, "encode_ms": t["encode_s"] * 1e3, "decode_ms": t["decode_s"] * 1e3}
        if use_visual:
            row.update(visual_host_ms=t["visual_host_s"] * 1e3, visual_ms=t["visual_s"] * 1e3)
        rows.append(row)
        log(f"  batch {i}: {wall:.1f} ms wall ({HI_B / wall * 1e3:.1f} documents/s); encode (with the page head"
            + (f"; host resize {row['visual_host_ms']:.1f} ms, visual branch {row['visual_ms']:.1f} ms" if use_visual
               else "") + f") {row['encode_ms']:.2f} ms, decode {row['decode_ms']:.2f} ms; pages "
            f"{out['pred_answer_pages']}")
    log(f"  launches in the two counted batches: {launches}")
    want = dict(HIVT5_SERVE_LAUNCHES)
    if use_visual:
        want.update({"vit_layer_norm": 24, "vit_gemm": 48, "vit_attention": 12})
    for name, n in want.items():
        if launches[name] != 2 * n:
            raise AssertionError(f"Hi-VT5 serving launched {name} {launches[name]} times, not 2 x {n}")

    if use_visual:  # imageless pages are masked: the first document has no render at all
        batch, aux = batches[1]
        tb = to_device(batch, g.device)
        with torch.inference_mode():
            pv, pvalid = engine._page_visual(tb, aux)
            want_valid = np.array([[p < len(d.words) and d.images is not None and d.images[p] is not None
                                    for p in range(HI_P)] for d in docs[HI_B:2 * HI_B]])
            if not (pvalid.cpu().numpy() == want_valid).all():
                raise AssertionError("Hi-VT5 visual branch: the render validity is not the documents' renders")
            mixed, _ = hm.encode_document(engine.params, engine.cfg, tb, pv, pvalid)
            plain, _ = hm.encode_document(engine.params, engine.cfg, tb)
        err = (mixed[0] - plain[0]).abs().max().item()
        log(f"  the imageless document's embedding with and without the visual branch: max_abs_err {err:.3e} "
            f"(limit {tol(torch.bfloat16, plain[0]):.1e}); {int(pvalid.sum())} of {HI_ROWS} page slots have a render")
        if not (err <= tol(torch.bfloat16, plain[0]) and not torch.allclose(mixed[1], plain[1])):
            raise AssertionError(f"Hi-VT5 visual branch: imageless pages not masked ({err})")
    mean = lambda key: sum(r[key] for r in rows) / len(rows)
    summary = {k: mean(k) for k in rows[0]}
    summary.update(docs_per_s=HI_B / summary["wall_ms"] * 1e3, batches=rows,
                   case=f"t5-base Hi-VT5 B{HI_B} x {HI_P} page slots ({HI_PAGES} pages), {HI_ROWS} rows of T "
                        f"{HI_K + HI_T + (VIT_T if use_visual else 0)}, bf16, int8 cache, K3 on, 16 new tokens")
    labels = torch.from_numpy(ingestor.answer_labels(batches[1][1]["answers"], max_len=16, seed=SEED))
    return launches, summary, engine, (batches[1][0], labels.to(engine.device))


def hivt5_attention_viz(engine, served) -> dict:
    """10e, first part: `attention_viz` on a served batch (bf16), its answer
    labels as the decoder input: page relevance sums to 1 over the valid
    pages (1e-3) and is 0 on the padded slots."""
    from rag_docvqa_tpu_torch.data.contract import to_device
    from rag_docvqa_tpu_torch.models import hivt5 as hm

    batch, labels = served
    with torch.inference_mode():
        out = hm.attention_viz(engine.params, engine.cfg, to_device(batch, engine.device), labels)
    rel = out["page_relevance"]
    valid = torch.arange(HI_P, device=rel.device)[None, :] < torch.tensor(HI_PAGES, device=rel.device)[:, None]
    total = rel.sum(1)
    t5c = engine.cfg.t5
    ok = (torch.isfinite(out["cross_attn"]).all()
          and out["cross_attn"].shape == (t5c.num_decoder_layers, HI_B, t5c.num_heads, 16, HI_TE)
          and (total - 1).abs().max().item() <= 1e-3 and not rel[~valid].any())
    log(f"  attention_viz: cross_attn {tuple(out['cross_attn'].shape)}, page relevance sums "
        f"{total.min().item():.6f}-{total.max().item():.6f}, 0 on the {int((~valid).sum())} padded slots: {ok}")
    if not ok:
        raise AssertionError("attention_viz: page relevance does not sum to 1 over valid pages or is not 0 elsewhere")
    return {"relevance_sum_min": total.min().item(), "relevance_sum_max": total.max().item()}


def train_hivt5(g: torch.Generator, steps: int = 6):
    """10d, last part: `make_hivt5_train_step` at t5-base, bf16 compute on f32 masters, B
    16 x 8 page slots (128 rows of T 522), 16-token labels, one batch
    repeated; K6, K7 and K8 launched; the total loss and `ret_loss` fall;
    forward, backward and update ms by CUDA events; the peak memory."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps, to_device
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.models import hivt5 as hm
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec
    from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
    from rag_docvqa_tpu_torch.training.train_step import TrainState, make_hivt5_train_step

    dev = g.device
    ingestor = DocVQAIngestor(HashTokenizer(32128), ChunkSpec(chunk_size=60, overlap=10), Caps(max_pages=HI_P))
    batch, aux = ingestor.ingest(hivt5_documents(SEED + 12))
    batch = to_device(batch, dev)
    labels = torch.from_numpy(ingestor.answer_labels(aux["answers"], max_len=16, seed=SEED)).to(dev)
    cfg = hm.HiVT5Config(max_doc_pages=HI_P, page_tokens=HI_K, page_seq_len=HI_T)
    params = hm.init_hivt5_params(g, cfg)  # f32 masters
    # the bench row's schedule (lr 1e-4, 10 warmup steps of 1000): at 6d's 2e-4 after 2 warmup steps the
    # page head overshoots on the repeated batch and ret_loss rises (2.60, 2.60, 3.39, 5.35, 5.74, 4.34 on an
    # NVIDIA H100 80GB HBM3 at 700 W)
    opt = build_optimizer(lr=1e-4, warmup_steps=10, total_steps=1000,
                          mask=trainable_mask(params, ("t5", "spatial", "page_emb", "page_head")))
    state = TrainState.create(params, opt)
    step = make_hivt5_train_step(cfg, opt, bf16_compute=True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rows = []
    for i in range(steps):
        ev = {n: torch.cuda.Event(enable_timing=True) for n in ("start", "forward", "backward", "update")}
        t0 = time.perf_counter()
        ev["start"].record()
        state, m = step(state, batch, labels, mark=lambda n: ev[n].record())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        row = {k: m[k].item() for k in ("loss", "lm_loss", "ret_loss", "grad_norm")}
        row.update(wall_ms=wall, forward_ms=ev["start"].elapsed_time(ev["forward"]),
                   backward_ms=ev["forward"].elapsed_time(ev["backward"]),
                   update_ms=ev["backward"].elapsed_time(ev["update"]))
        rows.append(row)
        log(f"  step {i + 1}: loss {row['loss']:.4f} (lm {row['lm_loss']:.4f}, ret {row['ret_loss']:.4f}), grad norm "
            f"{row['grad_norm']:.3f}, {wall:.1f} ms (forward {row['forward_ms']:.1f}, backward "
            f"{row['backward_ms']:.1f}, update {row['update_ms']:.1f})")
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  launches in the {steps} steps: {launches}; peak memory {peak:.2f} GiB")
    check_launched(launches, TRAIN_KERNELS, "Hi-VT5 training")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows):
        raise AssertionError("Hi-VT5 training: non-finite loss or grad norm")
    for k in ("loss", "ret_loss"):
        if not rows[-1][k] < rows[0][k]:
            raise AssertionError(f"Hi-VT5 training: {k} did not fall on the repeated batch: {[r[k] for r in rows]}")
    steady = rows[1:]
    mean = lambda k: sum(r[k] for r in steady) / len(steady)
    summary = {"ms": mean("wall_ms"), "forward_ms": mean("forward_ms"), "backward_ms": mean("backward_ms"),
               "update_ms": mean("update_ms"), "peak_memory_gib": peak,
               "losses": [r["loss"] for r in rows], "ret_losses": [r["ret_loss"] for r in rows],
               "case": f"t5-base Hi-VT5 B{HI_B} x {HI_P} page slots, {HI_ROWS} rows of T {HI_K + HI_T}, 16-token "
                       f"labels, bf16 compute, mean of steps 2-{steps}"}
    log(f"  mean of steps 2-{steps}: {summary['ms']:.1f} ms per step (forward {summary['forward_ms']:.1f}, backward "
        f"{summary['backward_ms']:.1f}, update {summary['update_ms']:.1f}); peak {peak:.2f} GiB")
    del state, params
    return launches, summary


def hivt5_clis() -> dict:
    """10e, second part: the port's train and eval entry points on
    configs/HiVT5_tiny.yml on the card (f32 weights, bf16 compute in the
    step), in this process; then the eval entry point from the trained
    checkpoint on the card and on the CPU, whose summaries must agree."""
    import contextlib
    import io
    import tempfile

    from rag_docvqa_tpu_torch import eval as port_eval
    from rag_docvqa_tpu_torch import train as port_train

    model, data = os.path.join(REPO, "configs/HiVT5_tiny.yml"), os.path.join(REPO, "configs/Synthetic.yml")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            result = port_train.main(["-m", model, "-d", data, "--no-eval-start", f"save_dir={tmp}"])
        train_s = time.perf_counter() - t0
        losses = [h["train_loss"] for h in result["history"]]
        epochs = [line for line in printed.getvalue().splitlines() if "train_loss=" in line]
        log(f"  train CLI: {epochs} ({train_s:.1f} s)")
        t0 = time.perf_counter()
        card = port_eval.main(["-m", model, "-d", data, "--ckpt", tmp])[0]
        eval_s = time.perf_counter() - t0
        cpu = port_eval.main(["-m", model, "-d", data, "--ckpt", tmp, "--device", "cpu"])[0]
    log(f"  eval CLI from its checkpoint: card {card} ({eval_s:.1f} s); CPU {cpu}")
    if not (all(math.isfinite(x) for x in losses) and card["n_samples"] == cpu["n_samples"] > 0):
        raise AssertionError(f"Hi-VT5 CLIs: losses {losses}, summaries {card} {cpu}")
    for k in ("accuracy", "anls", "retrieval_precision"):
        if abs(card[k] - cpu[k]) > 1e-6:
            raise AssertionError(f"Hi-VT5 eval CLI: {k} {card[k]} on the card, {cpu[k]} on the CPU")
    return {"train_losses": losses, "train_s": train_s, "eval": card, "eval_s": eval_s}


# --------------------------------------------------------------------------- #
# phase 11: the VT5 family's training forms; documents from local files
# --------------------------------------------------------------------------- #
P2S_B, P2S_N = 8, 1024  # pix2struct-base rows at the generator's 1024-patch budget
P2S_VALID = (1024,) * 6 + (700, 333)  # the last rows end in padded patches
VIS_B, VIS_T = 8, 512 + VIT_T  # t5-base with the ViT-base visual tokens: T 709 = 11 * 64 + 5
AQ_B, AQ_T, AQ_H, AQ_DK = 8, 128, 4, 16  # the answer-quality model's encoder rows (tests/test_torch_e2e_...)
REMAT_MODES = (False, "layer", True)
REMAT_TOL = 1e-4  # relative, on each step's loss and grad norm against the plain step (see remat_runs)


def p2s_patch_mask(dev) -> torch.Tensor:
    return torch.arange(P2S_N, device=dev)[None, :] < torch.tensor(P2S_VALID, device=dev)[:, None]


def visual_key_mask(dev) -> torch.Tensor:
    """(8, 709): ragged text (512 - 37 b tokens), then 197 visual tokens,
    valid but on every third row (a page without a render)."""
    ids = torch.arange(VIS_T, device=dev)[None, :]
    text = torch.tensor([512 - 37 * b for b in range(VIS_B)], device=dev)[:, None]
    render = torch.tensor([b % 3 != 2 for b in range(VIS_B)], device=dev)[:, None]
    return (ids < text) | ((ids >= 512) & render)


def layer_bwd_cases(checks: Checks, label: str, x, x1, dy, mask, bias, l, H: int, eps: float, gated: bool,
                    iters: int = 5, device: bool = True) -> None:
    """K7 (`t5_ffn_bwd`) and K8 (`t5_attn_bwd`) against the same functions on
    the plain parts (K7's ReLU taking the kernel's decisions, as 6b), within
    `rel_tol`, then timed (`device`: also on the device) beside their parts'
    bounds."""
    from rag_docvqa_tpu_torch.models.layers import rms_norm
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dt = x.dtype
    ffn = (x1, dy, l["ln1"], tuple(l[k] for k in fe.layer_keys(gated)[4:]))
    got = fe.t5_ffn_bwd(*ffn, eps=eps, gated=gated)
    if gated:  # no step in GELU: the plain version as it is
        want, names = fe.t5_ffn_bwd_reference(*ffn, eps=eps, gated=True), ("dx1", "dln1", "dwi0", "dwi1", "dwo")
    else:
        relu = MaskedRelu(kernel_relu_masks([x1], [l["ln1"]], [l["wi"]], eps))
        want = fe._ffn_bwd(*ffn, eps, False, rms_norm, fe.gemm_reference, relu.gemm_bwd, fe.rms_norm_bwd_reference)
        names = ("dx1", "dln1", "dwi", "dwo")
        log(f"  ReLU signs where the plain f32 GEMM and the kernel differ, K7 at {label}: {relu.flips}")
    for name, a, b in zip(names, (got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        checks.compare("t5_ffn_bwd", f"{label} {name}", a, b, rel_tol(dt, b))
    del got, want
    att = (x, dy, mask, bias, l["wqkv"], l["wo"], l["ln0"])
    got, want = fe.t5_attn_bwd(*att, num_heads=H, eps=eps), fe.t5_attn_bwd_reference(*att, num_heads=H, eps=eps)
    if (got[4] is None) != (bias is None):
        raise AssertionError(f"t5_attn_bwd {label}: a bias gradient without a bias, or none with one")
    for name, a, b in zip(("dx", "dln0", "dwqkv", "dwo", "dbias"), got, want):
        if b is not None:
            checks.compare("t5_attn_bwd", f"{label} {name}", a, b, rel_tol(dt, b))
    del got, want
    torch.cuda.empty_cache()
    ffn_pb, att_pb = PartsBound(), PartsBound()
    fe._ffn_bwd(*ffn, eps, gated, *map(ffn_pb.wrap, (fe.rms_norm_rows, fe.gemm, fe.gemm_bwd, fe.rms_norm_bwd)))
    fe._attn_bwd(*att, H, eps, *map(att_pb.wrap, (fe.rms_norm_rows, fe.gemm, fa.flash_attention_fwd,
                                                  fa.flash_attention_bwd, fe.gemm_bwd, fe.rms_norm_bwd)))
    checks.timed("t5_ffn_bwd", label, lambda: fe.t5_ffn_bwd(*ffn, eps=eps, gated=gated),
                 lambda: fe.t5_ffn_bwd_reference(*ffn, eps=eps, gated=gated), iters=iters, parts_bound=ffn_pb,
                 device=device)
    checks.timed("t5_attn_bwd", label, lambda: fe.t5_attn_bwd(*att, num_heads=H, eps=eps),
                 lambda: fe.t5_attn_bwd_reference(*att, num_heads=H, eps=eps), iters=iters, parts_bound=att_pb,
                 device=device)
    torch.cuda.empty_cache()


def t5_base_layer_bwd(checks: Checks, g: torch.Generator, label: str, B: int, T: int, mask, **kw) -> None:
    """`layer_bwd_cases` for one t5-base layer (random weights, norms in
    [0.5, 1.5)) with the shared bf16 rel-pos bias `encode` makes, at B x T,
    bf16."""
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev, bf16 = g.device, torch.bfloat16
    cfg = t5m.T5Config()
    params = t5m.init_t5_params(g, t5m.T5Config(num_encoder_layers=1, num_decoder_layers=1))
    l = {k: v.detach().to(bf16) for k, v in fe.fuse_t5_blocks(params.encoder.layers, False)[0].items()}
    l["ln0"] = (torch.rand(cfg.d_model, generator=g, device=dev) + 0.5).to(bf16)
    l["ln1"] = (torch.rand(cfg.d_model, generator=g, device=dev) + 0.5).to(bf16)
    pos = torch.arange(T)
    bias = t5m.relative_bias(params.encoder.rel_bias, pos, pos, True, cfg)[0].to(bf16).contiguous()
    x, x1, dy = (torch.randn((B, T, cfg.d_model), generator=g, device=dev).to(bf16) for _ in range(3))
    layer_bwd_cases(checks, label, x, x1, dy, mask, bias, l, cfg.num_heads, cfg.layer_norm_eps, gated=False, **kw)


def check_train_form_kernels(checks: Checks, g: torch.Generator) -> None:
    """11a: K6, K7 and K8 in the forms and at the shapes this phase's paths
    give them, each against its plain version and timed on the device (K6
    beside autograd through SDPA with the same mask): the gated, bias-free
    layer of the pix2struct-base tower (d 768, 12 heads, gated d_ff 2048) at
    B 8 x 1024 patches whose last rows end in padding; t5-base with the shared
    bf16 rel-pos bias at T 709 (512 text + 197 visual tokens; the last 64-row
    tile holds 5) with the visual key mask; and the f32 SIMT forms of K2, K3
    and K6 at the answer-quality model's d_kv 16."""
    from rag_docvqa_tpu_torch.ops import decode_attention as da
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev, bf16, f32 = g.device, torch.bfloat16, torch.float32
    randn = lambda *s: torch.randn(s, generator=g, device=dev).to(bf16)
    H, eps = 12, 1e-6

    # pix2struct-base: the gated tower layer without a bias
    mask = p2s_patch_mask(dev)
    tag = f"B{P2S_B} T{P2S_N} pix2struct-base gated bf16, padded patches"
    flash_bwd_case(checks, g, P2S_B, P2S_N, H, H, 64, bf16, None, False, 1.0, fe.T5_MASK_VALUE, mask,
                   f"B{P2S_B} H12 T{P2S_N} dk64 no bias t5-mask bf16, padded patches", timed=True)
    l = cast_layer(random_t5_layer(g, 768, 768, 2048, True, 64), bf16)
    layer_bwd_cases(checks, tag, randn(P2S_B, P2S_N, 768), randn(P2S_B, P2S_N, 768), randn(P2S_B, P2S_N, 768),
                    mask, None, l, H, eps, gated=True)

    # t5-base at the visual branch's length with the shared bf16 bias
    mask = visual_key_mask(dev)
    tag = f"B{VIS_B} T{VIS_T} t5-base bf16, visual key mask"
    flash_bwd_case(checks, g, VIS_B, VIS_T, H, H, 64, bf16, "shared", False, 1.0, fe.T5_MASK_VALUE, mask,
                   f"B{VIS_B} H12 T{VIS_T} dk64 shared bias t5-mask bf16, visual key mask", timed=True)
    t5_base_layer_bwd(checks, g, tag, VIS_B, VIS_T, mask)

    # the answer-quality model, f32: K2 and K6 on their SIMT kernels, K3 over an f32 cache, at d_kv 16
    lens = [AQ_T - 9 * b for b in range(AQ_B)]
    tag = f"B{AQ_B} H{AQ_H} T{AQ_T} dk{AQ_DK} shared bias t5-mask f32 (answer-quality model)"
    flash_case(checks, g, AQ_B, AQ_T, AQ_H, AQ_H, AQ_DK, f32, "shared", False, 1.0, fe.T5_MASK_VALUE, lens, tag,
               twice=True)
    flash_bwd_case(checks, g, AQ_B, AQ_T, AQ_H, AQ_H, AQ_DK, f32, "shared", False, 1.0, fe.T5_MASK_VALUE, lens, tag)
    L = decode_inputs(g, AQ_B, AQ_H, AQ_DK, AQ_T, f32, lens)
    args = (L["k2"], L["v2"], L["m"], L["ks"], L["vs"])
    checks.compare("decode_cross_attention", f"B{AQ_B} H{AQ_H} dk{AQ_DK} Te{AQ_T} f32 cache, f32 q (answer-quality "
                   "model)", da.fused_cross_attention(L["q"], *args), da.cross_attention_reference(L["q"], *args),
                   F32_TOL)
    torch.cuda.empty_cache()


def grad_against_plain(what: str, params, loss_fn, module, gated: bool, exempt=("t5.encoder.rel_bias",)) -> dict:
    """The full-width f32 loss of `loss_fn(params)` -> (loss, {name: part})
    and its gradient through the kernels' layer (`module.t5_layer_train`:
    the K1 parts forward, K7 and K8 with K6 backward) against autograd of the
    same with the plain layer in its place, whose ReLU takes the kernels'
    decisions (`KernelReluDecisions`, as 6c; a gated layer has no step). The
    losses within F32_TOL; every gradient root that either pass reaches
    finite and within F32_TOL of its largest value, the roots in `exempt`
    (a rel-pos table, whose gradient comes through the bf16 bias in both)
    within BF16_REL_TOL."""
    from rag_docvqa_tpu_torch.models.layers import rms_norm
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    params.requires_grad_(True)
    names, ins = zip(*params.named_parameters())
    kernel_layer = module.t5_layer_train
    record = kernel_layer if gated else KernelReluDecisions(kernel_layer)
    relu = MaskedRelu([] if gated else record.masks)  # consumed by the plain pass, after the kernel pass filled it

    def plain_layer(x, key_mask, bias, l, *, num_heads, eps, gated):
        return fe._t5_layer(x, key_mask, bias, l, num_heads, eps, gated, rms_norm, relu.gemm,
                            fa.flash_attention_reference)

    results = []
    t0 = time.perf_counter()
    for layer in (record, plain_layer):
        module.t5_layer_train = layer
        try:
            loss, parts = loss_fn(params)
            results.append((loss, parts, torch.autograd.grad(loss, ins, allow_unused=True)))
        finally:
            module.t5_layer_train = kernel_layer
        if len(results) == 1:
            torch.cuda.synchronize()
            kernel_ms = (time.perf_counter() - t0) * 1e3
    (loss, parts, got), (want_loss, want_parts, want) = results
    log(f"  ReLU signs where the plain f32 GEMM and the kernels differ, {what}: {relu.flips}")
    losses = {k: (parts[k].item(), want_parts[k].item()) for k in parts}
    losses["loss"] = (loss.item(), want_loss.item())
    log(f"  {what}, kernels vs plain layer: " + ", ".join(f"{k} {a:.6f} / {b:.6f}" for k, (a, b) in losses.items()))
    for k, (a, b) in losses.items():
        if not (math.isfinite(a) and abs(a - b) <= F32_TOL * max(1.0, abs(b))):
            raise AssertionError(f"{what} {k}: {a} through the kernels, {b} through the plain layer")
    rels = {}
    for name, a, b in zip(names, got, want):
        if (a is None) != (b is None):
            raise AssertionError(f"{what} gradient {name}: reached in one path only")
        if a is not None:
            rel = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
            rels[name] = rel if torch.isfinite(a).all() else math.inf
    limit = lambda name: BF16_REL_TOL if name in exempt else F32_TOL
    ranked = sorted(rels, key=lambda n: -rels[n] / limit(n))
    log(f"  {what} gradient, {len(rels)} roots, of each its largest value: "
        + "; ".join(f"d{n} {rels[n]:.3e} (limit {limit(n):.0e})" for n in ranked[:6]))
    bad = [n for n in ranked if not rels[n] <= limit(n)]
    if bad:
        raise AssertionError(f"{what} gradient: {bad} above their limits, or not finite")
    worst_name = max((n for n in rels if limit(n) == F32_TOL), key=rels.get)
    params.requires_grad_(False)
    return {"grad_roots": len(rels), "grad_worst_rel_err": rels[worst_name], "grad_worst": worst_name,
            "relu_flips": relu.flips, "loss_err": max(abs(a - b) for a, b in losses.values()),
            "kernel_pass_ms": kernel_ms}


def random_gen_inputs(g: torch.Generator, B: int, S: int, lens, n_labels: int):
    """GeneratorInputs as `assemble_concat` gives them: token ids, [0, 1000]
    boxes, layout labels below `n_labels`, a key mask of `lens` text tokens a
    row."""
    from rag_docvqa_tpu_torch.data.contract import GeneratorInputs

    dev = g.device
    ri = lambda lo, hi, *s: torch.randint(lo, hi, s, generator=g, device=dev)
    return GeneratorInputs(input_ids=ri(3, 32128, B, S), input_boxes=ri(0, 1000, B, S, 4),
                           input_labels=ri(0, n_labels, B, S),
                           attention_mask=torch.arange(S, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None])


def random_patches(g: torch.Generator, B: int, N: int, valid) -> tuple:
    """(B, N, 2 + 768) flattened patches (1-based row and column ids on a
    32-wide grid, normalized pixels) and their (B, N) mask of `valid` patches
    a row; padded patches are zero, as `extract_flattened_patches` pads."""
    dev = g.device
    ids = torch.arange(N, device=dev)
    x = torch.randn((B, N, 770), generator=g, device=dev)
    x[:, :, 0], x[:, :, 1] = (1 + ids // 32).float(), (1 + ids % 32).float()
    mask = ids[None, :] < torch.tensor(valid, device=dev)[:, None]
    return x * mask[..., None], mask


def labels_of(g: torch.Generator, B: int, vocab: int, ends) -> torch.Tensor:
    """(B, 16) answer labels, -100 after each row's end (an EOS, 1, before it)."""
    dev = g.device
    labels = torch.randint(2, vocab, (B, 16), generator=g, device=dev)
    pos = torch.arange(16, device=dev)[None, :]
    ends = torch.tensor(ends, device=dev)[:, None]
    return torch.where(pos == ends, 1, torch.where(pos > ends, -100, labels))


def check_train_form_grads(g: torch.Generator) -> dict:
    """11b: the full-width f32 gradient checks of `grad_against_plain`:
    Pix2Struct `forward_train` at pix2struct-base on 2 rows of 1024 patches
    (one ending in 324 padded ones), and VT5 `forward_train` at t5-base with
    the layout labels embedded and the LayoutT5 head, B 2 of 512 text tokens
    and 197 ViT-base visual tokens (`visual_features`: K14, outside
    autograd, as JAX takes them precomputed; the second row's masked)."""
    from rag_docvqa_tpu_torch.models import pix2struct as p2s
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m

    out = {}
    cfg = p2s.Pix2StructConfig()
    params = p2s.init_p2s_params(g, cfg)
    patches, mask = random_patches(g, 2, P2S_N, (P2S_N, 700))
    labels = labels_of(g, 2, cfg.text.vocab_size, (15, 6))
    out["p2s"] = grad_against_plain(
        f"Pix2Struct forward_train f32 pix2struct-base, 2 rows of {P2S_N} patches", params,
        lambda p: (p2s.forward_train(p, cfg, patches, mask, labels)[0], {}), p2s, gated=True, exempt=())
    del params
    torch.cuda.empty_cache()

    cfg = vt5m.VT5Config(use_visual=True, use_layout_labels="Embed")
    params = vt5m.init_vt5_params(g, cfg)
    gen = random_gen_inputs(g, 2, 512, (512, 300), cfg.n_layout_labels)
    with torch.no_grad():
        visual = vt5m.visual_features(params, cfg, torch.randn((2, 224, 224, 3), generator=g, device=g.device))
    visual_mask = torch.tensor([[True], [False]], device=g.device).expand(2, visual.shape[1])
    labels = labels_of(g, 2, 32128, (15, 9))
    out["vt5_visual_layout"] = grad_against_plain(
        f"VT5 forward_train f32 t5-base, T {512 + visual.shape[1]} with ViT-base visual tokens, layout head", params,
        lambda p: (vt5m.forward_train(p, cfg, gen, labels, visual, visual_mask)[0], {}), t5m, gated=False)
    del params, visual
    torch.cuda.empty_cache()
    return out


def timed_steps(fn, steps: int) -> list:
    """CUDA-event ms of `steps` calls of fn(mark) -> metrics, each split into
    forward, backward and update at the marks fn makes."""
    rows = []
    for _ in range(steps):
        ev = {n: torch.cuda.Event(enable_timing=True) for n in ("start", "forward", "backward", "update")}
        t0 = time.perf_counter()
        ev["start"].record()
        m = fn(lambda n: ev[n].record())
        torch.cuda.synchronize()
        row = {k: v.item() for k, v in m.items() if not k.startswith("grad_norm/")}
        row.update(wall_ms=(time.perf_counter() - t0) * 1e3, forward_ms=ev["start"].elapsed_time(ev["forward"]),
                   backward_ms=ev["forward"].elapsed_time(ev["backward"]),
                   update_ms=ev["backward"].elapsed_time(ev["update"]))
        rows.append(row)
    return rows


def vt5_train_batch(g: torch.Generator):
    """6d's batch: 8 synthetic documents of 8 pages x 120 words at the
    configs/RAGVT5.yml values, ingested and on the card, 32-token labels."""
    from rag_docvqa_tpu_torch.data.contract import Caps, to_device
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    ingestor = DocVQAIngestor(HashTokenizer(32128), ChunkSpec(chunk_size=60, overlap=10), Caps())
    docs = make_corpus(8, n_pages=8, words_per_page=120, seed=SEED)
    ingestor.caps = ingestor.plan_caps(docs)
    batch, aux = ingestor.ingest(docs)
    labels = torch.from_numpy(ingestor.answer_labels(aux["answers"], max_len=32, seed=SEED)).to(g.device)
    return to_device(batch, g.device), labels


def hivt5_train_batch(g: torch.Generator):
    """10d's batch: B 16 x 8 page slots of 10 + 512 tokens, 16-token labels."""
    from rag_docvqa_tpu_torch.data.contract import Caps, to_device
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    ingestor = DocVQAIngestor(HashTokenizer(32128), ChunkSpec(chunk_size=60, overlap=10), Caps(max_pages=HI_P))
    batch, aux = ingestor.ingest(hivt5_documents(SEED + 12))
    labels = torch.from_numpy(ingestor.answer_labels(aux["answers"], max_len=16, seed=SEED)).to(g.device)
    return to_device(batch, g.device), labels


def train_forms_bf16(g: torch.Generator) -> tuple:
    """11c: bf16 compute on f32 masters. Six `make_train_step` steps of VT5
    with the layout labels embedded and the LayoutT5 head on 6d's repeated
    batch, at 10d's schedule (lr 1e-4, 10 warmup steps): finite, the loss
    falls. One forward and backward of VT5 `forward_train` at T 709 (512 text
    tokens and 197 visual tokens from `visual_features`, outside autograd),
    B 8; one of Pix2Struct `forward_train` at pix2struct-base, B 8 x 1024
    patches; each timed by CUDA events with its peak memory. Returns (the
    launches of each path, the summary)."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig
    from rag_docvqa_tpu_torch.models import pix2struct as p2s
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
    from rag_docvqa_tpu_torch.training.train_step import TrainState, cast_params, make_train_step

    launches, summary = {}, {}
    batch, labels = vt5_train_batch(g)
    cfg = vt5m.VT5Config(use_layout_labels="Embed")
    params = vt5m.init_vt5_params(g, cfg)
    opt = build_optimizer(lr=1e-4, warmup_steps=10, total_steps=1000,
                          mask=trainable_mask(params, ("t5", "spatial", "layout_emb", "layout_scale", "layout_head")))
    state = TrainState.create(params, opt)
    step = make_train_step(cfg, RAGConfig(page_retrieval="concat", chunk_num=10, include_surroundings=0,
                                          max_source_length=512), opt, bf16_compute=True)
    kernels.reset_launch_counts()
    holder = [state]

    def one(mark):
        holder[0], m = step(holder[0], batch, labels, mark=mark)
        return m

    rows = timed_steps(one, 6)
    launches["train_layout"] = dict(kernels.LAUNCHES)
    check_launched(launches["train_layout"], TRAIN_KERNELS, "VT5 training with the LayoutT5 head")
    losses = [r["loss"] for r in rows]
    log(f"  VT5 with the layout head, B 8 T 512, bf16 compute: losses {[round(x, 4) for x in losses]}, "
        f"{sum(r['wall_ms'] for r in rows[1:]) / 5:.1f} ms a step (mean of steps 2-6)")
    if not (all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows) and losses[-1] < losses[0]):
        raise AssertionError(f"VT5 training with the layout head: the loss did not fall, or is not finite: {losses}")
    summary["train_layout"] = {"losses": losses, "ms": sum(r["wall_ms"] for r in rows[1:]) / 5,
                               "backward_ms": sum(r["backward_ms"] for r in rows[1:]) / 5,
                               "case": "t5-base VT5 B8 T512, use_layout_labels Embed + LayoutT5 head, bf16 compute"}
    del state, holder, params, batch
    torch.cuda.empty_cache()

    def fwd_bwd(tag, params, loss_fn, iters=3):
        """Forward and backward of loss_fn(p) on the bf16 copy p of `params`,
        the gradient to the f32 masters: ms by events (mean of `iters` after
        one), peak memory, launches."""
        params.requires_grad_(True)
        ins = [p for p in params.parameters()]

        def run():
            p = cast_params(params, torch.bfloat16)
            loss = loss_fn(p)
            grads = torch.autograd.grad(loss, ins, allow_unused=True)
            return loss, grads

        loss, grads = run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            loss, grads = run()
        end.record()
        torch.cuda.synchronize()
        counts = {k: v // iters for k, v in kernels.LAUNCHES.items()}
        finite = all(gr is None or torch.isfinite(gr).all() for gr in grads) and math.isfinite(loss.item())
        row = {"ms": start.elapsed_time(end) / iters, "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "loss": loss.item(), "case": tag}
        log(f"  {tag}: forward + backward {row['ms']:.1f} ms, peak {row['peak_memory_gib']:.2f} GiB, loss "
            f"{row['loss']:.4f}; launches a pass {counts}")
        if not finite:
            raise AssertionError(f"{tag}: a non-finite loss or gradient")
        params.requires_grad_(False)
        return counts, row

    cfg = vt5m.VT5Config(use_visual=True)
    params = vt5m.init_vt5_params(g, cfg)
    gen = random_gen_inputs(g, VIS_B, 512, [512 - 37 * b for b in range(VIS_B)], cfg.n_layout_labels)
    with torch.no_grad():
        visual = vt5m.visual_features(cast_params(params, torch.bfloat16), cfg,
                                      torch.randn((VIS_B, 224, 224, 3), generator=g, device=g.device))
    visual_mask = visual_key_mask(g.device)[:, 512:]
    labels = labels_of(g, VIS_B, 32128, [15 - b for b in range(VIS_B)])
    launches["train_visual"], summary["train_visual"] = fwd_bwd(
        f"VT5 forward_train t5-base B{VIS_B} T{VIS_T} (ViT-base visual tokens), bf16 compute", params,
        lambda p: vt5m.forward_train(p, cfg, gen, labels, visual, visual_mask)[0])
    check_launched(launches["train_visual"], TRAIN_KERNELS, "VT5 training with visual tokens")
    del params, visual
    torch.cuda.empty_cache()

    cfg = p2s.Pix2StructConfig()
    params = p2s.init_p2s_params(g, cfg)
    patches, mask = random_patches(g, P2S_B, P2S_N, P2S_VALID)
    labels = labels_of(g, P2S_B, cfg.text.vocab_size, [15 - b for b in range(P2S_B)])
    launches["p2s_train"], summary["p2s_train"] = fwd_bwd(
        f"Pix2Struct forward_train pix2struct-base B{P2S_B} x {P2S_N} patches, bf16 compute", params,
        lambda p: p2s.forward_train(p, cfg, patches, mask, labels)[0])
    check_launched(launches["p2s_train"], TRAIN_KERNELS, "Pix2Struct training")
    if launches["p2s_train"]["flash_bwd"] != cfg.vision.num_layers:
        raise AssertionError(f"Pix2Struct training: {launches['p2s_train']['flash_bwd']} K6 launches, not one a layer")
    del params
    torch.cuda.empty_cache()
    return launches, summary


def remat_runs(g: torch.Generator) -> tuple:
    """11d: `remat` False, "layer" and True on 10d's Hi-VT5 batch (B 16 x 8
    page slots, t5-base; the JAX bench trains this row with "layer") and on
    6d's VT5 batch, three bf16-compute steps each from the same f32 masters:
    the losses and grad norms within REMAT_TOL (relative) of the plain
    step's, the first loss equal bit for bit (its forward is the same
    launches on the same inputs), ms per step and peak memory
    (`max_memory_allocated`). The kernels give the same bits on a second
    launch (6a, 6b), so a recomputed layer takes the first pass's ReLU
    decisions; REMAT_TOL leaves room only for a library reduction whose order
    may change between the passes (a wrong gradient moves the grad norm by
    whole per cent). Returns (launches by run, summary)."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig
    from rag_docvqa_tpu_torch.models import hivt5 as hm
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
    from rag_docvqa_tpu_torch.training.train_step import TrainState, make_hivt5_train_step, make_train_step

    launches, summary = {}, {}
    hcfg = hm.HiVT5Config(max_doc_pages=HI_P, page_tokens=HI_K, page_seq_len=HI_T)
    vcfg = vt5m.VT5Config()
    rag = RAGConfig(page_retrieval="concat", chunk_num=10, include_surroundings=0, max_source_length=512)
    for model, cfg, batch_fn, roots in (
            ("hivt5", hcfg, hivt5_train_batch, ("t5", "spatial", "page_emb", "page_head")),
            ("vt5", vcfg, vt5_train_batch, ("t5", "spatial"))):
        batch, labels = batch_fn(g)
        runs = {}
        for remat in REMAT_MODES:
            # the same f32 masters for every mode, drawn anew so that no second copy adds to the peak
            init = hm.init_hivt5_params if model == "hivt5" else vt5m.init_vt5_params
            params = init(torch.Generator(device=g.device).manual_seed(SEED + 111), cfg)
            opt = build_optimizer(lr=1e-4, warmup_steps=10, total_steps=1000, mask=trainable_mask(params, roots))
            holder = [TrainState.create(params, opt)]
            step = (make_hivt5_train_step(cfg, opt, remat=remat, bf16_compute=True) if model == "hivt5" else
                    make_train_step(cfg, rag, opt, bf16_compute=True, remat=remat))

            def one(mark):
                holder[0], m = step(holder[0], batch, labels, mark=mark)
                return m

            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            rows = timed_steps(one, 3)
            name = f"{model}_remat_{str(remat).lower()}"
            launches[name] = dict(kernels.LAUNCHES)
            runs[str(remat)] = {"losses": [r["loss"] for r in rows], "grad_norms": [r["grad_norm"] for r in rows],
                                "ms": sum(r["wall_ms"] for r in rows[1:]) / 2,
                                "backward_ms": sum(r["backward_ms"] for r in rows[1:]) / 2,
                                "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
            log(f"  {model} remat={remat!r}: losses {runs[str(remat)]['losses']}, grad norms "
                f"{[round(x, 5) for x in runs[str(remat)]['grad_norms']]}, {runs[str(remat)]['ms']:.1f} ms a step "
                f"(backward {runs[str(remat)]['backward_ms']:.1f}), peak {runs[str(remat)]['peak_memory_gib']:.2f} GiB")
            check_launched(launches[name], TRAIN_KERNELS, f"{model} training with remat={remat!r}")
            del holder, params, opt, step
        plain = runs["False"]
        for mode, run in runs.items():
            diffs = [abs(a - b) / max(abs(b), 1e-30) for k in ("losses", "grad_norms") for a, b in zip(run[k], plain[k])]
            run["max_rel_diff"] = max(diffs)
            run["bit_equal"] = run["losses"] == plain["losses"] and run["grad_norms"] == plain["grad_norms"]
            if not (run["losses"][0] == plain["losses"][0] and run["max_rel_diff"] <= REMAT_TOL):
                raise AssertionError(f"{model} remat={mode}: losses {run['losses']} and grad norms "
                                     f"{run['grad_norms']} against the plain step's {plain['losses']} "
                                     f"{plain['grad_norms']} (limit {REMAT_TOL})")
        summary[model] = runs
        del batch
        torch.cuda.empty_cache()
    return launches, summary


def write_mp_docvqa(root: str, n_docs: int = 6, n_pages=(2, 3), words: int = 40, images: bool = True,
                    seed: int = 0, bands: bool = False):
    """An MP-DocVQA directory in the reference layout: imdb_dir/imdb_val.npy
    (a header, then a record a question with question_id, question, answers,
    answer_page_idx, imdb_doc_pages, image_name, ocr_tokens and
    ocr_normalized_boxes) and, with `images` (needs Pillow),
    images_dir/<image_name>.jpg holding seeded (48, 40, 3) pages as PNG bytes
    (with `bands`, (160, 128, 3) pages, white above a seeded row and one
    seeded dark colour below it: regions a layout detector can tell apart);
    from the synthetic planted-fact corpus, its documents cycling through
    `n_pages` pages of `words` words. Returns (imdb_dir, images_dir)."""
    import numpy as np

    from rag_docvqa_tpu_torch.data.synthetic import make_corpus

    imdb, image_dir = os.path.join(root, "imdb"), os.path.join(root, "images")
    os.makedirs(imdb)
    os.makedirs(image_dir)
    rng = np.random.RandomState(seed)
    records = [{"dataset_version": "fixture"}]
    for i, d in enumerate(make_corpus(n_docs, n_pages=max(n_pages), words_per_page=words, seed=seed)):
        n = n_pages[i % len(n_pages)]
        names = [f"doc{i}_p{p}" for p in range(n)]
        if images:
            from PIL import Image

            for name in names:
                page = banded_page(rng, 160, 128) if bands else rng.randint(0, 256, (48, 40, 3)).astype(np.uint8)
                Image.fromarray(page).save(os.path.join(image_dir, f"{name}.jpg"), "PNG")
        records.append({"question_id": 1000 + i, "question": d.question, "answers": list(d.answers),
                        "answer_page_idx": min(d.answer_page_idx, n - 1), "imdb_doc_pages": n, "image_id": f"doc{i}",
                        "image_name": names, "ocr_tokens": [list(d.words[p]) for p in range(n)],
                        "ocr_normalized_boxes": [np.asarray(d.boxes[p], np.float32) for p in range(n)]})
    np.save(os.path.join(imdb, "imdb_val.npy"), np.asarray(records, dtype=object), allow_pickle=True)
    return imdb, image_dir


def local_files() -> tuple:
    """11e: documents from local files. Which of Pillow, `datasets`,
    pdfminer and pdf2image this machine has; an MP-DocVQA directory of 32
    questions (3-4 pages of 120 words, seeded page images where Pillow is)
    under a temporary directory; the eval entry point over it on the card
    at t5-base f32 (configs/RAGVT5.yml, concat, 16 new tokens) with in-process
    ingest and with two ingest workers, whose summaries must be equal; Hi-VT5
    (configs/HiVT5_tiny.yml) with the per-page ViT-base branch and
    RAG-Pix2Struct (configs/Pix2Struct_tiny.yml) from the page images (from
    the synthetic corpus's seeded images where Pillow is missing); then
    `MPIngestor.ingest` with 1, 2 and 4 workers against the single-process
    ingestor on phase 5's corpus (32 documents x 8 pages x 120 words), pages
    a second, median of 5 rounds taken in turns after a warmup. Returns
    (launches, summary)."""
    import contextlib
    import importlib.util
    import io
    import statistics
    import tempfile

    import numpy as np

    from rag_docvqa_tpu_torch import eval as port_eval
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.ingest_mp import MPIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    summary = {"packages": {name: importlib.util.find_spec(mod) is not None
                            for name, mod in (("Pillow", "PIL"), ("datasets", "datasets"), ("pdfminer", "pdfminer"),
                                              ("pdf2image", "pdf2image"))}}
    log(f"  optional packages on this machine: {summary['packages']}")
    pillow = summary["packages"]["Pillow"]
    launches = {}
    cfgs = lambda name: os.path.join(REPO, "configs", name)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        imdb, images = write_mp_docvqa(tmp, n_docs=32, n_pages=(3, 4), words=120, images=pillow)
        data = ["-d", cfgs("MP-DocVQA.yml"), f"imdb_dir={imdb}", f"images_dir={images}",
                f"use_images={str(pillow).lower()}"]
        runs = {}
        for workers in (0, 2):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                s = port_eval.main(["-m", cfgs("RAGVT5.yml"), *data, "max_new_tokens=16", "--ingest-workers",
                                    str(workers)])[0]
            runs[workers] = dict(s, total_s=time.perf_counter() - t0)
            launches[f"eval_mp_docvqa_workers_{workers}"] = dict(kernels.LAUNCHES)
            log(f"  eval CLI on the MP-DocVQA directory, --ingest-workers {workers}: {runs[workers]}")
        strip = lambda s: {k: v for k, v in s.items() if k not in ("wall_time", "total_s")}
        if strip(runs[0]) != strip(runs[2]) or runs[0]["n_samples"] != 32:
            raise AssertionError(f"eval CLI on local files: {runs[0]} in-process, {runs[2]} with 2 ingest workers")
        check_launched(launches["eval_mp_docvqa_workers_2"], ("t5_rms_norm", "t5_gemm", "flash_fwd"),
                       "MP-DocVQA evaluation")
        summary["eval_mp_docvqa"] = runs
        image_data = data if pillow else ["-d", cfgs("Synthetic.yml"), "synthetic_images=true", "n_val_docs=32"]
        for name, model, extra, need in (("hivt5_page_images", "HiVT5_tiny.yml", ["use_visual=true"],
                                          ("t5_rms_norm", "t5_gemm", "flash_fwd") + VIT_KERNELS),
                                         ("p2s_page_images", "Pix2Struct_tiny.yml", [], P2S_KERNELS[:4])):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                s = port_eval.main(["-m", cfgs(model), *image_data, *extra])[0]
            launches[name] = dict(kernels.LAUNCHES)
            summary[name] = dict(s, total_s=time.perf_counter() - t0)
            log(f"  eval CLI, {model} from the page images ({'MP-DocVQA files' if pillow else 'synthetic'}): "
                f"{summary[name]}; launches {launches[name]}")
            if s["n_samples"] != 32 or not 0.0 <= s["retrieval_precision"] <= 1.0:
                raise AssertionError(f"eval CLI {model} from the page images: {s}")
            check_launched(launches[name], need, f"{model} from page images")

    tok = HashTokenizer(32128)
    spec = ChunkSpec(chunk_size=60, overlap=10)
    docs = make_corpus(32, n_pages=8, words_per_page=120, seed=SEED)
    single = DocVQAIngestor(tok, spec, Caps())
    caps = single.plan_caps(docs)
    single.caps = caps
    want, _ = single.ingest(docs)

    pools = {f"workers_{w}": MPIngestor(tok, spec, caps, num_workers=w) for w in (1, 2, 4)}
    try:
        ingest = {"single_process": single.ingest, **{k: p.ingest for k, p in pools.items()}}
        for name, fn in ingest.items():  # starts the workers and warms every word-matrix cache
            got, _ = fn(docs)
            if not all(np.array_equal(getattr(got, f), getattr(want, f)) for f in want.__dataclass_fields__):
                raise AssertionError(f"MPIngestor {name}: arrays differ from the single-process ingest")
        times = {name: [] for name in ingest}
        for _ in range(5):  # in turns, so that the host's other load falls on every mode alike
            for name, fn in ingest.items():
                t0 = time.perf_counter()
                fn(docs)
                times[name].append(time.perf_counter() - t0)
    finally:
        for p in pools.values():
            p.close()
    pages = sum(len(d.words) for d in docs)
    rates = {name: pages / statistics.median(t) for name, t in times.items()}
    summary["ingest_pages_per_s"] = rates
    log(f"  host ingest of 32 documents x 8 pages x 120 words, pages a second (median of 5 rounds in turns; 1 worker "
        f"is the in-process path, as in JAX): {({k: round(v, 1) for k, v in rates.items()})}; {os.cpu_count()} host "
        "cores")
    return launches, summary


def answer_quality() -> tuple:
    """11f: the two cases of tests/test_torch_e2e_answer_quality.py on the
    card, f32, decode through K3 (as the cases set it): the tiny VT5 after 500 steps and the tiny
    Hi-VT5 after 800 answer every planted question (ANLS 1.0; Hi-VT5's page
    head finds the planted page). Returns (launches, summary)."""
    import importlib.util

    from rag_docvqa_tpu_torch import kernels

    spec = importlib.util.spec_from_file_location(
        "port_answer_quality", os.path.join(REPO, "tests", "test_torch_e2e_answer_quality.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    launches, summary = {}, {}
    for name, fn in (("answer_quality_vt5", cases.vt5_case), ("answer_quality_hivt5", cases.hivt5_case)):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn("cuda")
        res["total_s"] = time.perf_counter() - t0
        launches[name] = dict(kernels.LAUNCHES)
        summary[name] = {k: v for k, v in res.items() if k not in ("answers", "planted")}
        log(f"  {name}: {summary[name]}; launches {launches[name]}")
        check_launched(launches[name], TRAIN_KERNELS + ("decode_cross_attention",), name)
        if not (res["anls"] == 1.0 and res["answers"] == res["planted"] and res.get("retrieval_precision", 1.0) == 1.0):
            raise AssertionError(f"{name}: ANLS {res['anls']}, retrieval {res.get('retrieval_precision')}, answers "
                                 f"{res['answers']} against {res['planted']}")
    return launches, summary


# --------------------------------------------------------------------------- #
# phase 12: the layout detectors, precompute layouts, layout-guided serving, the transfer, the apps
# --------------------------------------------------------------------------- #
DIT_B = 16  # pages a DiT forward (`precompute layouts` batches as many)
YOLO_B = 4
DIT_MARGIN = 1e-3  # class-map pixels whose top-two logit margin exceeds this must agree
DIT_ARGS = ["layout_d_model=768", "layout_num_layers=12", "layout_num_heads=12", "layout_mlp_dim=3072",
            "layout_image_size=224", "layout_out_indices=[3,5,7,11]"]  # root precompute.py:106-113 at DiT-base
YOLO_ARGS = ["layout_width=32", "layout_image_size=1024"]  # YOLOConfig()'s widths through the CLI's keys
# Pix2StructConfig()'s widths (pix2struct-base: d 768, d_kv 64, 12 heads, d_ff 2048, 12 vision and 12 decoder
# layers) through the eval CLI's keys, with phase 9f's k and new tokens
P2S_BASE_ARGS = ["d_model=768", "d_kv=64", "num_heads=12", "d_ff=2048", "num_layers=12", "chunk_num=10",
                 "max_new_tokens=16"]


def banded_page(rng, h: int, w: int):
    """A uint8 page from `rng` (a numpy RandomState): white above a row drawn
    from [h/4, 3h/4) and one dark colour below it, regions a layout detector
    can tell apart (write_mp_docvqa's `bands`)."""
    import numpy as np

    page = np.full((h, w, 3), 255, np.uint8)
    page[rng.randint(h // 4, 3 * h // 4):] = rng.randint(0, 80, 3)
    return page


def banded_pages(seed: int, n: int, h: int = 256, w: int = 192) -> list:
    """`n` banded pages from a seed."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return [banded_page(rng, h, w) for _ in range(n)]


@contextlib.contextmanager
def plain_vit_layers():
    """`vit_encode` through K14's plain version (the layer function
    models/vit.py calls, swapped for `vit_layer_reference`), on the card."""
    from rag_docvqa_tpu_torch.models import vit
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    saved = vit.fused_vit_layer_parts
    vit.fused_vit_layer_parts = fe.vit_layer_reference
    try:
        yield
    finally:
        vit.fused_vit_layer_parts = saved


def dit_base(g: torch.Generator):
    """The DiT detector at DiT-base width (`BeitSegConfig()`'s ViT: d 768, 12
    layers and heads, mlp 3072, 224 px; BEiT, no absolute positions, a rel-pos
    bias a layer, layer-scale 0.1, no final LayerNorm; out_indices (3, 5, 7,
    11), 12 labels) from the seed, its rel-pos tables N(0, 0.5^2), its
    attention and MLP biases N(0, 0.1^2) and its BatchNorm statistics random,
    so that neither the bias path nor inference-mode BN is an identity."""
    from rag_docvqa_tpu_torch.models.conv import BatchNorm
    from rag_docvqa_tpu_torch.models.layout_seg import BeitSegConfig, init_beit_seg_params
    from rag_docvqa_tpu_torch.models.vit import ViTConfig

    cfg = BeitSegConfig(vit=ViTConfig(arch="beit", use_abs_pos=False, use_rel_pos_bias=True, layer_scale_init=0.1,
                                      use_final_layernorm=False))
    params = init_beit_seg_params(g, cfg)
    for layer in params.backbone.layers:
        layer.rel_bias_table.normal_(0.0, 0.5, generator=g)
        for name in ("q_b", "v_b", "o_b", "fc1_b", "fc2_b"):
            getattr(layer, name).normal_(0.0, 0.1, generator=g)
    for m in params.modules():
        if isinstance(m, BatchNorm):
            m.mean.normal_(0.0, 0.5, generator=g)
            m.var.uniform_(0.5, 2.0, generator=g)
    return cfg, params


def host_ms(fn, n: int = 3, calls: int = 1):
    """Host-clock ms a call of `fn`: the median over `n` turns of `calls`
    calls, each turn ended by a synchronize. With {form: fn} of two forms
    the turns go A B B A, `n` times over, and each form's median comes back
    in a dict."""
    import statistics

    forms = fn if isinstance(fn, dict) else {None: fn}
    order = [*forms, *reversed(forms)] if len(forms) == 2 else list(forms)
    times = {name: [] for name in forms}
    for _ in range(n):
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                forms[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / calls * 1e3)
    ms = {name: statistics.median(v) for name, v in times.items()}
    return ms if isinstance(fn, dict) else ms[None]


def check_dit(checks: Checks, g: torch.Generator) -> tuple:
    """12a: the DiT detector at full width, B 16 pages, f32 with TF32 off: its
    logits through K14 against the same model through K14's plain version,
    within `rel_tol`; the class maps equal on every pixel whose top-two margin
    exceeds DIT_MARGIN (the flips elsewhere counted); K14's launches in one
    detector batch exactly 12 layers' (24 vit_layer_norm, 48 vit_gemm, 12
    vit_attention); the BEiT layer and its attention at B 16 T 197 in f32 and
    bf16 against their plain versions, timed on the device beside SDPA; the
    backbone, the head and the whole detector (host resize, forward, boxes)
    per page. Returns (launches, summary)."""
    import torch.nn.functional as F

    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.models import layout_seg as seg
    from rag_docvqa_tpu_torch.models.vit import vit_encode
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev, f32 = g.device, torch.float32
    cfg, params = dit_base(g)
    pages = banded_pages(SEED + 12, DIT_B)
    pix = seg.dit_pixels(pages, cfg.vit.image_size, dev)
    summary = {}
    with torch.inference_mode():
        got = seg.beit_segment_logits(params, cfg, pix)
        with plain_vit_layers():
            want = seg.beit_segment_logits(params, cfg, pix)
        checks.compare("dit_detector", f"logits B{DIT_B} DiT-base f32 through K14", got, want, rel_tol(f32, want))
        up = lambda x: seg._resize(x.permute(0, 3, 1, 2), cfg.vit.image_size, cfg.vit.image_size)
        gmap, wlog = up(got).argmax(1), up(want)
        top2 = wlog.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > DIT_MARGIN
        flips = gmap != wlog.argmax(1)
        summary["class_map"] = {"pixels": flips.numel(), "flipped": int(flips.sum()),
                                "flipped_above_margin": int(flips[clear].sum()), "margin": DIT_MARGIN,
                                "classes": sorted(torch.unique(gmap).tolist())}
        log(f"  DiT class maps, {DIT_B} pages x 224^2: {summary['class_map']}")
        if summary["class_map"]["flipped_above_margin"]:
            raise AssertionError(f"DiT class maps: {summary['class_map']}")
        del want, wlog

        det = seg.make_dit_detector(params, cfg)
        det.batch(pages)  # warmup
        kernels.reset_launch_counts()
        found = det.batch(pages)
        launches = dict(kernels.LAUNCHES)
        want_launches = {"vit_layer_norm": 24, "vit_gemm": 48, "vit_attention": 12}
        if {k: launches[k] for k in VIT_KERNELS} != want_launches or sum(launches.values()) != 84:
            raise AssertionError(f"one DiT batch launched {launches}, not K14's {want_launches}")
        summary["boxes_per_page"] = [len(b) for b, _ in found]
        log(f"  DiT detector, one batch of {DIT_B}: launches {launches}; boxes per page {summary['boxes_per_page']}")

        # K14 at the detector's shape: the BEiT layer (rel-pos bias, layer-scale) and its attention
        B, T, d, H, dff = DIT_B, VIT_T, VIT_D, VIT_H, VIT_MLP
        layer = random_vit_layer(g, d, dff, H, T, True, True)
        mask = torch.ones((B, T), dtype=torch.bool, device=dev)
        vkw = dict(num_heads=H, eps=1e-12)
        scale = (d // H) ** -0.5
        for dtype, tag in ((f32, "f32"), (torch.bfloat16, "bf16")):
            l = cast_layer(layer, dtype)
            x = torch.randn((B, T, d), generator=g, device=dev).to(dtype)
            out, ref = fe.fused_vit_layer_parts(x, mask, l, **vkw), fe.vit_layer_reference(x, mask, l, **vkw)
            label = f"beit B{B} T{T} ViT-base {tag} (DiT detector)"
            checks.compare("vit_layer", label, out, ref, tol(dtype, ref))
            checks.timed("vit_layer", label, lambda: fe.fused_vit_layer_parts(x, mask, l, **vkw),
                         lambda: fe.vit_layer_reference(x, mask, l, **vkw), iters=5, device=True,
                         io_bytes=nbytes(x, mask, out, *l.values()),
                         ops=2.0 * B * T * (4 * d * d + 2 * d * dff) + 4.0 * B * H * T * T * (d // H),
                         ops_in=op_type(dtype))
            qkv = torch.randn((B, T, 3, H, d // H), generator=g, device=dev).to(dtype)
            bias = l["bias"]
            out, ref = fe.vit_attention(qkv, mask, bias, scale), fe.vit_attention_reference(qkv, mask, bias, scale)
            label = f"B{B} H{H} T{T} dh{d // H} bias {tag} (DiT detector)"
            checks.compare("vit_attention", label, out, ref, tol(dtype, ref))
            qt, kt, vt = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            add = bias[None, :, :, :T].to(dtype)
            checks.timed("vit_attention", label, lambda: fe.vit_attention(qkv, mask, bias, scale),
                         lambda: fe.vit_attention_reference(qkv, mask, bias, scale),
                         library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add, scale=scale),
                         library_is="SDPA, the rel-pos bias as an additive mask",
                         io_bytes=nbytes(qkv, mask, bias, out), ops=4.0 * B * H * T * T * (d // H),
                         ops_in=op_type(dtype), device=True)
            del l, x, out, ref, qkv
        torch.cuda.empty_cache()

        _, per_layer = vit_encode(params.backbone, cfg.vit, pix, return_hidden_states=True)
        summary["backbone_ms"] = time_ms(lambda: vit_encode(params.backbone, cfg.vit, pix, return_hidden_states=True),
                                         iters=5)
        summary["head_ms"] = time_ms(lambda: seg.beit_seg_head(params, cfg, per_layer), iters=5)
        summary["head_device_ms"] = device_ms(lambda: seg.beit_seg_head(params, cfg, per_layer), iters=5)
        with plain_vit_layers():
            summary["backbone_plain_ms"] = time_ms(
                lambda: vit_encode(params.backbone, cfg.vit, pix, return_hidden_states=True), iters=3)
        summary["detector_ms_per_page"] = host_ms(lambda: det.batch(pages)) / DIT_B
        # PyTorch's default for convolutions, which the CLIs keep: cuDNN's TF32 on (this script turns it off)
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = seg.beit_segment_logits(params, cfg, pix)
            summary["tf32"] = {"head_ms": time_ms(lambda: seg.beit_seg_head(params, cfg, per_layer), iters=5),
                               "detector_ms_per_page": host_ms(lambda: det.batch(pages)) / DIT_B,
                               "logits_drift": (tf32 - got).abs().max().item(),
                               "class_map_flips": int((up(tf32).argmax(1) != gmap).sum()),
                               "same_boxes": det.batch(pages) == found}
        finally:
            torch.backends.cudnn.allow_tf32 = False
    log(f"  DiT detector B{DIT_B} f32: backbone {summary['backbone_ms']:.3f} ms (12 K14 layers; plain "
        f"{summary['backbone_plain_ms']:.3f}), head {summary['head_ms']:.3f} ms (device {summary['head_device_ms']:.3f}), "
        f"the whole detector {summary['detector_ms_per_page']:.3f} ms a page (host resize, forward, boxes); with "
        f"cuDNN's TF32 on: {summary['tf32']}")
    return launches, summary


def live_yolo(g: torch.Generator, params, cfg, pix) -> None:
    """Make the seeded YOLO's outputs depend on its input, in place, so that
    a comparison of two runs can fail. The seeded output convs are N(0,
    0.01^2) over a class bias of -4.59, which leave the raw outputs the bias
    and little else; here they are N(0, 1/fan_in) with N(0, 1) biases. Every
    BatchNorm gets a scale U[0.5, 1), a shift N(0, 0.5^2), and statistics
    that divide its input on `pix` by the input's root mean square, so each
    layer's output stays O(1) through the depth. (Subtracting the mean too
    cancels the pages' constant regions and magnifies a rounding a
    hundredfold; scales up to 1.5 magnify it 2.4 times more. With these, at
    width 16 and 512 px on the CPU, the f32 forward is within 5.4e-5 of
    float64's and one with kernels rounded to 10 bits 0.09 off, outputs up
    to 6.4.)"""
    from rag_docvqa_tpu_torch.models import yolo
    from rag_docvqa_tpu_torch.models.conv import BatchNorm

    with torch.no_grad():
        for m in params.modules():
            if isinstance(m, BatchNorm):
                m.w.uniform_(0.5, 1.0, generator=g)
                m.b.normal_(0.0, 0.5, generator=g)
        for hp in params.head:
            for name in ("reg_out", "cls_out"):
                hp[name].weight.normal_(0.0, hp[name].weight[0].numel() ** -0.5, generator=g)
                hp[name].bias.normal_(0.0, 1.0, generator=g)
        saved = yolo.batch_norm

        def calibrate(x, bn, eps):
            bn.mean.zero_()
            bn.var.copy_(x.float().pow(2).mean((0, 2, 3)))
            return saved(x, bn, eps)

        yolo.batch_norm = calibrate
        try:
            yolo.yolo_forward(params, cfg, pix)
        finally:
            yolo.batch_norm = saved


def check_yolo(g: torch.Generator) -> tuple:
    """12b: YOLO at `YOLOConfig()` (width 32, depth 1, 1024 px, 10 classes),
    B 4 pages, f32, cuDNN TF32 off. The seeded weights: ms a page and the
    candidates over `conf_thresh` (none). The same network made
    input-dependent (`live_yolo`): `yolo_forward`'s raw outputs and
    `yolo_detect` on the card against the port's CPU run on the same
    parameters (raw outputs within `rel_tol`, boxes and scores within F32_TOL,
    classes equal where the top two class scores differ by more than
    F32_TOL); then with cuDNN's TF32 on, whose drift of the raw outputs must
    exceed that limit, the control that the comparison can fail. Returns
    (launches, summary)."""
    import copy

    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.models import yolo

    cfg = yolo.YOLOConfig()
    params = yolo.init_yolo_params(g, cfg)
    pix = yolo.yolo_pixels(banded_pages(SEED + 13, YOLO_B, 512, 384), cfg.image_size, g.device)
    summary = {}
    with torch.inference_mode():
        kernels.reset_launch_counts()
        seeded = yolo.yolo_detect(params, cfg, pix)
        launches = dict(kernels.LAUNCHES)
        summary["over_conf_thresh"] = int((seeded[1] >= cfg.conf_thresh).sum())
        summary["ms_per_page"] = time_ms(lambda: yolo.yolo_detect(params, cfg, pix), iters=5) / YOLO_B
        summary["device_ms_per_page"] = device_ms(lambda: yolo.yolo_detect(params, cfg, pix), iters=5) / YOLO_B
    live_yolo(g, params, cfg, pix)
    cpu_params, cpu_pix = copy.deepcopy(params).cpu(), pix.cpu()
    with torch.inference_mode():
        got, raw = yolo.yolo_detect(params, cfg, pix), yolo.yolo_forward(params, cfg, pix)
        t0 = time.perf_counter()
        want, raw_cpu = yolo.yolo_detect(cpu_params, cfg, cpu_pix), yolo.yolo_forward(cpu_params, cfg, cpu_pix)
        summary["cpu_s"] = time.perf_counter() - t0
        errs, limits = {}, {}
        for i, ((reg, cls), (creg, ccls)) in enumerate(zip(raw, raw_cpu)):
            for name, a, b in ((f"reg/{cfg.strides[i]}", reg, creg), (f"cls/{cfg.strides[i]}", cls, ccls)):
                errs[name], limits[name] = (a.cpu() - b).abs().max().item(), rel_tol(torch.float32, b)
                if not errs[name] <= limits[name]:
                    raise AssertionError(f"YOLO raw {name}: card against CPU {errs[name]} (limit {limits[name]})")
        for name, a, b in (("boxes", got[0], want[0]), ("scores", got[1], want[1])):
            errs[name] = (a.cpu() - b).abs().max().item()
            if not errs[name] <= F32_TOL:
                raise AssertionError(f"YOLO {name}: card against CPU {errs[name]}")
        probs = torch.cat([torch.sigmoid(c.float()).reshape(YOLO_B, -1, cfg.num_classes) for _, c in raw_cpu], 1)
        top2 = probs.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > F32_TOL
        differ = got[2].cpu() != want[2]
        summary["live"] = {"max_abs_err_vs_cpu": errs, "limits": limits,
                           "raw_max_abs": max(b.abs().max().item() for pair in raw_cpu for b in pair),
                           "between_pages": min((b[0] - b[1]).abs().max().item() for pair in raw_cpu for b in pair),
                           "classes_differing": {"all": int(differ.sum()), "above_margin": int(differ[clear].sum())},
                           "over_conf_thresh": int((got[1] >= cfg.conf_thresh).sum())}
        if summary["live"]["classes_differing"]["above_margin"]:
            raise AssertionError(f"YOLO classes: {summary['live']['classes_differing']}")
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32, raw_tf32 = yolo.yolo_detect(params, cfg, pix), yolo.yolo_forward(params, cfg, pix)
            summary["tf32_ms_per_page"] = time_ms(lambda: yolo.yolo_detect(params, cfg, pix), iters=5) / YOLO_B
        finally:
            torch.backends.cudnn.allow_tf32 = False
        drift = {f"{kind}/{cfg.strides[i]}": (a - b).abs().max().item()
                 for i, (pt, pf) in enumerate(zip(raw_tf32, raw)) for kind, a, b in zip(("reg", "cls"), pt, pf)}
        summary["tf32_drift"] = {"raw": drift, "boxes": (tf32[0] - got[0]).abs().max().item(),
                                 "scores": (tf32[1] - got[1]).abs().max().item(),
                                 "classes_differing": int((tf32[2] != got[2]).sum())}
    log(f"  YOLO B{YOLO_B} 1024 px f32, seeded: {summary['ms_per_page']:.3f} ms a page (device "
        f"{summary['device_ms_per_page']:.3f}; cuDNN TF32 on: {summary['tf32_ms_per_page']:.3f}), "
        f"{summary['over_conf_thresh']} candidates over conf_thresh {cfg.conf_thresh}; launches "
        f"{sum(launches.values())} (no kernel of the port)")
    log(f"  YOLO made input-dependent, card against the CPU (CPU run {summary['cpu_s']:.1f} s): {summary['live']}; "
        f"cuDNN TF32 on, drift {summary['tf32_drift']}")
    if not any(drift[k] > limits[k] for k in drift):
        raise AssertionError(f"YOLO with cuDNN's TF32 drifts {drift}, within the f32 limits {limits}: the "
                             "card-against-CPU check cannot tell a 10-bit-mantissa path from f32")
    return launches, summary


@contextlib.contextmanager
def stage_times(targets):
    """For the duration, the host-clock seconds spent in each (module, name,
    stage, kind) target are summed into the dict yielded under `stage`: a
    "call" is timed from call to return ("sync" ends it with a synchronize,
    so that the device's work lands in its stage), an "iter" (a generator
    function) inside each step of the iteration."""
    import collections

    times = collections.defaultdict(float)

    def call(fn, stage, sync):
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            times[stage] += time.perf_counter() - t0
            return out
        return timed

    def steps(fn, stage):
        def timed(*a, **k):
            it = fn(*a, **k)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                finally:
                    times[stage] += time.perf_counter() - t0
                yield item
        return timed

    saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in targets]
    for (mod, name, stage, kind), (_, _, fn) in zip(targets, saved):
        setattr(mod, name, steps(fn, stage) if kind == "iter" else call(fn, stage, kind == "sync"))
    try:
        yield times
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def layouts_end_to_end(g: torch.Generator) -> tuple:
    """12c: an MP-DocVQA directory of 32 questions (3-4 pages x 120 words,
    seeded banded pages: `write_mp_docvqa(bands=True)`) through `precompute
    layouts` on the card, DIT at DiT-base width and YOLO at its defaults,
    pages/s, its window split by stage (reading and decoding the pages, the
    host resize and copy, the forward, the boxes, the file); the DIT file
    read back through `use_precomputed_layouts`; the eval entry point
    (t5-base f32, concat, 16 new tokens) with the layouts;
    the same documents and layouts through `RAGVT5Engine.inference` at phase
    5's settings (bf16, int8 cross cache, K3) for K1-K3; the chunking with
    and without the layouts (the words chunked must differ); RAG-Pix2Struct's
    image chunks with and without the layouts, and RAG-Pix2Struct at
    pix2struct-base width (f32, k 10, 16 new tokens) with `chunk_mode:
    layout` through the eval entry point: K15, and every encode a bias-free
    tower. Returns (launches, summary)."""
    import contextlib
    import io
    import tempfile
    import types
    from dataclasses import replace

    import numpy as np

    from rag_docvqa_tpu_torch import eval as port_eval
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch import precompute as port_pre
    from rag_docvqa_tpu_torch.config import build_caps, build_chunk_spec, build_p2s_config, load_config
    from rag_docvqa_tpu_torch.data.datasets import build_dataset
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_pix2struct import P2SRAGConfig, RAGPix2StructEngine
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
    from rag_docvqa_tpu_torch.models import layout as layout_post
    from rag_docvqa_tpu_torch.models import layout_seg as seg
    from rag_docvqa_tpu_torch.models import pix2struct as p2s
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.models import yolo
    from rag_docvqa_tpu_torch.train import parse_overrides

    cfgs = lambda name: os.path.join(REPO, "configs", name)
    launches, summary = {}, {}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        imdb, images = write_mp_docvqa(tmp, n_docs=32, n_pages=(3, 4), words=120, bands=True)
        data = [f"imdb_dir={imdb}", f"images_dir={images}", "use_images=true"]
        paths = {}
        for det, extra in (("DIT", DIT_ARGS), ("YOLO", YOLO_ARGS)):
            paths[det] = os.path.join(tmp, f"layouts_{det}.npz")
            argv = ["layouts", "-m", cfgs("RAGVT5.yml"), "-d", cfgs("MP-DocVQA.yml"), "--detector", det,
                    "--out", paths[det], *data, *extra]
            with contextlib.redirect_stdout(io.StringIO()):
                port_pre.main(argv)  # warmup: the first forwards pick cuDNN's algorithms
            targets = [(port_pre, "layout_pages", "read_pages", "iter"), (np, "savez_compressed", "write", "call")]
            targets += ([(seg, "dit_pixels", "resize_copy", "sync"), (seg, "segment_map", "forward", "sync"),
                         (layout_post, "segmentation_to_layout", "boxes", "call"),
                         (layout_post, "filter_detections_dit", "boxes", "call")] if det == "DIT" else
                        [(yolo, "yolo_pixels", "resize_copy", "sync"), (yolo, "yolo_detect", "forward", "sync"),
                         (layout_post, "filter_detections_yolo", "boxes", "call")])
            kernels.reset_launch_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), stage_times(targets) as stages:
                port_pre.main(argv)
            line = json.loads(out.getvalue().strip().splitlines()[-1])
            launches[f"precompute_layouts_{det.lower()}"] = dict(kernels.LAUNCHES)
            z = np.load(paths[det], allow_pickle=True)
            found = [len(z[k].item()["boxes"]) for k in z.files]
            window_ms = line["n_pages"] / line["pages_per_sec"] * 1e3  # the CLI's own window, from its line
            split = {k: v * 1e3 / line["n_pages"] for k, v in stages.items()}
            split["other"] = window_ms / line["n_pages"] - sum(split.values())
            summary[f"precompute_{det.lower()}"] = dict(line, total_s=time.perf_counter() - t0,
                                                        pages_with_boxes=sum(1 for n in found if n),
                                                        boxes=sum(found), ms_per_page_by_stage=split)
            log(f"  precompute layouts --detector {det}: {summary[f'precompute_{det.lower()}']}; launches "
                f"{launches[f'precompute_layouts_{det.lower()}']}")
            if line["n_pages"] != 112 or len(z.files) != 112:
                raise AssertionError(f"precompute layouts {det}: {line}, {len(z.files)} keys")
        check_launched(launches["precompute_layouts_dit"], VIT_KERNELS, "precompute layouts (DIT)")

        lay = ["use_precomputed_layouts=true", f"precomputed_layouts_path={paths['DIT']}"]
        config = load_config(model=cfgs("RAGVT5.yml"), dataset=cfgs("MP-DocVQA.yml"), overrides=dict(
            imdb_dir=imdb, images_dir=images, use_images=True))
        plain_docs = list(build_dataset(dict(config), "val"))
        docs = list(build_dataset(dict(config, use_precomputed_layouts=True,
                                       precomputed_layouts_path=paths["DIT"]), "val"))
        z = np.load(paths["DIT"], allow_pickle=True)
        names = [list(r["image_name"]) for r in np.load(os.path.join(imdb, "imdb_val.npy"), allow_pickle=True)[1:]]
        if [d.layout for d in docs] != [[z[n].item() for n in ns] for ns in names]:
            raise AssertionError("use_precomputed_layouts: the documents' layouts are not the file's entries")
        tok = HashTokenizer(32128)
        ingestor = DocVQAIngestor(tok, build_chunk_spec(config), build_caps(config))
        ingestor.caps = ingestor.plan_caps(docs + plain_docs)
        (with_b, with_aux), (without_b, _) = ingestor.ingest(docs), ingestor.ingest(plain_docs)
        counts = {"chunks_with_layouts": int(with_b.chunk_mask.sum()), "chunks_without": int(without_b.chunk_mask.sum()),
                  "words_chunked_with_layouts": int(with_b.slot_mask.sum()),
                  "words_chunked_without": int(without_b.slot_mask.sum())}
        summary["vt5_chunking"] = counts
        log(f"  RAG-VT5 chunking of the 32 documents with and without the DIT layouts: {counts}")
        if counts["words_chunked_with_layouts"] == counts["words_chunked_without"]:
            raise AssertionError(f"the DIT layouts did not reach the chunking: {counts}")

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            s = port_eval.main(["-m", cfgs("RAGVT5.yml"), "-d", cfgs("MP-DocVQA.yml"), *data, *lay,
                                "max_new_tokens=16"])[0]
        launches["eval_layouts_vt5"] = dict(kernels.LAUNCHES)
        summary["eval_vt5"] = dict(s, total_s=time.perf_counter() - t0)
        log(f"  eval CLI, t5-base f32 concat with the DIT layouts: {summary['eval_vt5']}")
        if s["n_samples"] != 32:
            raise AssertionError(f"eval CLI with layouts: {s}")
        check_launched(launches["eval_layouts_vt5"], TOWER_KERNELS, "eval CLI with layouts")

        vt5_cfg = vt5m.VT5Config(t5=t5m.T5Config(decode_kv_int8=True, fused_decode_attn=True))
        engine = RAGVT5Engine(RAGConfig(page_retrieval="concat", chunk_num=10, max_source_length=512,
                                        max_new_tokens=16), vt5_cfg, vt5m.init_vt5_params(g, vt5_cfg).to(torch.bfloat16),
                              tok)
        with torch.inference_mode():
            engine.inference(with_b, with_aux)  # warmup
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = engine.inference(with_b, with_aux)
            summary["serve_bf16_ms"] = (time.perf_counter() - t0) * 1e3
        launches["serve_layouts"] = dict(kernels.LAUNCHES)
        log(f"  RAGVT5Engine.inference on the 32 layout-chunked documents, bf16, int8 cross cache, K3: "
            f"{summary['serve_bf16_ms']:.1f} ms; launches {launches['serve_layouts']}")
        check_launched(launches["serve_layouts"], SERVE_KERNELS, "layout-chunked serving")
        if not all(math.isfinite(c) for c in out["confidences"]):
            raise AssertionError("layout-chunked serving: a confidence is not finite")

        chunk = lambda mode, layouts: sum(
            len(RAGPix2StructEngine._chunk_pages(types.SimpleNamespace(cfg=P2SRAGConfig(chunk_mode=mode)), d.images,
                                                 d.layout if layouts else None)[0]) for d in docs)
        summary["p2s_chunks"] = {"layout": chunk("layout", True), "horizontal": chunk("horizontal", False)}
        log(f"  RAG-Pix2Struct image chunks of the 32 documents, layout mode and the grid mode: {summary['p2s_chunks']}")
        if summary["p2s_chunks"]["layout"] == summary["p2s_chunks"]["horizontal"]:
            raise AssertionError(f"the DIT layouts did not reach RAG-Pix2Struct's chunking: {summary['p2s_chunks']}")
        p2s_argv = ["-m", cfgs("Pix2Struct_tiny.yml"), "-d", cfgs("MP-DocVQA.yml"), *data, *lay, "chunk_mode=layout",
                    *P2S_BASE_ARGS]
        base, built = p2s.Pix2StructConfig(), build_p2s_config(load_config(
            model=cfgs("Pix2Struct_tiny.yml"), overrides=parse_overrides(P2S_BASE_ARGS)), 32128)
        if built.vision != base.vision or replace(built.text, vocab_size=base.text.vocab_size,
                                                  dropout_rate=base.text.dropout_rate) != base.text:
            raise AssertionError(f"the eval CLI's Pix2Struct at {P2S_BASE_ARGS} is {built}, not {base}")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            s = port_eval.main(p2s_argv)[0]
        launches["p2s_layouts"] = dict(kernels.LAUNCHES)
        summary["eval_p2s_layout"] = dict(s, total_s=time.perf_counter() - t0)
        log(f"  eval CLI, RAG-Pix2Struct at pix2struct-base width, f32, chunk_mode layout with the DIT layouts: "
            f"{summary['eval_p2s_layout']}; launches {launches['p2s_layouts']}")
        if s["n_samples"] != 32:
            raise AssertionError(f"RAG-Pix2Struct with layouts: {s}")
        check_launched(launches["p2s_layouts"], P2S_KERNELS[:4], "RAG-Pix2Struct in layout mode")
        L, encodes = base.vision.num_layers, launches["p2s_layouts"]["flash_fwd"] // base.vision.num_layers
        if encodes < 8:  # 4 batches of 8 questions, each a retrieve encode and a generator encode
            raise AssertionError(f"RAG-Pix2Struct in layout mode: {encodes} encodes")
        check_tower_route(launches["p2s_layouts"], L, encodes, "RAG-Pix2Struct at pix2struct-base in layout mode")
    return launches, summary


def check_transfer(g: torch.Generator) -> tuple:
    """12d: phase 5's batch of 32 (8 pages x 120 words, configs/RAGVT5.yml's
    chunking) through `device_put_batch` and `to_device`: every field equal
    bit for bit with its dtype (the queued form too); the bytes each moves and
    its ms, the median of 20 after a warmup, by CUDA events and by the host
    clock; then `evaluate` over 64 documents with phase 5's engine (bf16, int8
    cross cache, K3) copying with each: the same answers and confidences.
    Returns (launches, summary)."""
    import statistics

    import numpy as np

    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data import contract
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.data.transfer import device_put_batch, device_put_batch_async, narrow_tokens
    from rag_docvqa_tpu_torch.engine import evaluate as ev
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    dev, vocab = g.device, 32128
    tok = HashTokenizer(vocab)
    ingestor = DocVQAIngestor(tok, ChunkSpec(chunk_size=60, overlap=10), Caps())
    docs = make_corpus(64, n_pages=8, words_per_page=120, seed=SEED)
    ingestor.caps = ingestor.plan_caps(docs)
    batch, _ = ingestor.ingest(docs[:32])
    want = contract.to_device(batch, dev)
    for name, got in (("device_put_batch", device_put_batch(batch, vocab, dev)),
                      ("device_put_batch_async", device_put_batch_async(batch, vocab, dev).wait())):
        for f in want.__dataclass_fields__:
            a, b = getattr(got, f), getattr(want, f)
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"{name}: field {f} differs from to_device's ({a.dtype}, {b.dtype})")
    to_bytes = sum(np.asarray(getattr(batch, f)).size * (8 if np.asarray(getattr(batch, f)).dtype.kind in "iu"
                                                            else np.asarray(getattr(batch, f)).itemsize)
                   for f in batch.__dataclass_fields__)
    summary = {"to_device_bytes": to_bytes, "device_put_batch_bytes": device_put_batch_async(batch, vocab, dev).nbytes}

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        ev_ms, host = [], []
        for _ in range(20):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            ev_ms.append(start.elapsed_time(end))
        return {"events_ms": statistics.median(ev_ms), "host_ms": statistics.median(host)}

    summary["to_device"] = timed(lambda: contract.to_device(batch, dev))
    summary["device_put_batch"] = timed(lambda: device_put_batch(batch, vocab, dev))
    # where device_put_batch's host time goes: the range scan, and the whole queued call (scan, packing into
    # the pinned buffer, the copy and the widening queued) before any wait
    def host_only(fn):
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            del out
        return statistics.median(times)

    summary["device_put_batch"]["narrow_scan_host_ms"] = host_only(lambda: narrow_tokens(batch, vocab))
    summary["device_put_batch"]["queue_host_ms"] = host_only(lambda: device_put_batch_async(batch, vocab, dev))
    log(f"  transfer of one batch of 32 (8 pages x 120 words): {summary}")

    vt5_cfg = vt5m.VT5Config(t5=t5m.T5Config(decode_kv_int8=True, fused_decode_attn=True))
    engine = RAGVT5Engine(RAGConfig(page_retrieval="concat", chunk_num=10, max_source_length=512, max_new_tokens=16),
                          vt5_cfg, vt5m.init_vt5_params(g, vt5_cfg).to(torch.bfloat16), tok)

    class ToDevice:  # to_device in device_put_batch_async's place
        def __init__(self, b, _vocab, device):
            self.batch = contract.to_device(b, device)

        def wait(self):
            return self.batch

    saved = ev.device_put_batch_async

    def run(copy):  # evaluate over the 64 documents copying with `copy`: (result, s)
        ev.device_put_batch_async = copy
        try:
            t0 = time.perf_counter()
            return ev.evaluate(engine, docs, ingestor, batch_size=32), time.perf_counter() - t0
        finally:
            ev.device_put_batch_async = saved

    with torch.inference_mode():
        ev.evaluate(engine, docs[:32], ingestor, batch_size=32)  # warmup
        kernels.reset_launch_counts()
        got, t_put = run(saved)
        launches = dict(kernels.LAUNCHES)
        ref, t_to = run(ToDevice)  # A B B A
        summary["evaluate_to_device_s"] = [t_to, run(ToDevice)[1]]
        summary["evaluate_s"] = [t_put, run(saved)[1]]
    conf = lambda r: [s["pred_answer_conf"] for s in r["scores_by_samples"].values()]
    summary["confidence_max_abs_diff"] = max(abs(a - b) for a, b in zip(conf(got), conf(ref)))
    log(f"  evaluate over 64 documents, bf16, int8 cross cache, K3 (A B B A): {summary['evaluate_s']} s with "
        f"device_put_batch, {summary['evaluate_to_device_s']} s with to_device; answers equal: "
        f"{got['pred_answers'] == ref['pred_answers']}, confidences within {summary['confidence_max_abs_diff']:.2e}")
    if got["pred_answers"] != ref["pred_answers"] or summary["confidence_max_abs_diff"] != 0.0:
        raise AssertionError("evaluate: the answers or confidences differ between the two copies")
    check_launched(launches, SERVE_KERNELS, "evaluate with device_put_batch")
    return launches, summary


def apps(g: torch.Generator) -> tuple:
    """12e: `demo --serve` on 127.0.0.1 on the card (t5-base from
    configs/RAGVT5.yml, 16 new tokens, the engine's decode switched to an
    int8 cross cache and K3 as phase 5 sets it: the CLI has no key for
    either): one /sample and one /ask round trip over a socket, the /ask
    through K1-K3 with its overlay PNGs; then `noise_experiment` over 8
    documents (noise 0 and 3 pages, seeds 0 and 1). Both timed. Returns
    (launches, summary)."""
    import base64
    import contextlib
    import dataclasses
    import io
    import threading
    import types
    import urllib.request

    from rag_docvqa_tpu_torch import demo as port_demo
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch import noise_experiment as port_noise

    cfgs = lambda name: os.path.join(REPO, "configs", name)
    launches, summary = {}, {}
    session = port_demo.build_session(types.SimpleNamespace(
        model=cfgs("RAGVT5.yml"), dataset=cfgs("Synthetic.yml"), pdf=None, doc=0, device="cuda",
        overrides=["n_val_docs=4", "max_new_tokens=16", "decode_kv_int8=true"]))
    engine = session._engine
    engine.vt5_cfg = dataclasses.replace(engine.vt5_cfg, t5=dataclasses.replace(engine.vt5_cfg.t5,
                                                                                 fused_decode_attn=True))
    httpd = port_demo.make_server(session, 0, "127.0.0.1")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        ask = lambda: json.loads(urllib.request.urlopen(urllib.request.Request(
            f"{base}/ask", data=json.dumps({"question": "what is the total?", "doc": 1}).encode(),
            headers={"Content-Type": "application/json"}), timeout=300).read())
        ask()  # warmup
        t0 = time.perf_counter()
        sample = json.loads(urllib.request.urlopen(f"{base}/sample?idx=1&layout=1&chunks=1", timeout=300).read())
        summary["sample_ms"] = (time.perf_counter() - t0) * 1e3
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        answer = ask()
        summary["ask_ms"] = (time.perf_counter() - t0) * 1e3
        launches["demo_ask"] = dict(kernels.LAUNCHES)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    pngs = answer.get("viz_png_b64", [])
    summary.update(pages=sample["num_pages"], overlays=len(pngs), chunks=len(answer["chunks"]),
                   answer=answer["answer"], confidence=answer["confidence"])
    log(f"  demo --serve on 127.0.0.1: /sample {summary['sample_ms']:.1f} ms, /ask {summary['ask_ms']:.1f} ms "
        f"({summary['chunks']} chunks, {summary['overlays']} overlay PNGs); launches {launches['demo_ask']}")
    if not (sample["idx"] == 1 and len(sample["pages_png_b64"]) == sample["num_pages"] == len(pngs) and
            all(base64.b64decode(b)[:8] == b"\x89PNG\r\n\x1a\n" for b in pngs + sample["pages_png_b64"]) and
            answer["chunks"] and math.isfinite(answer["confidence"])):
        raise AssertionError(f"demo round trip: {summary}")
    check_launched(launches["demo_ask"], SERVE_KERNELS, "demo /ask")

    kernels.reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = port_noise.main(["-m", cfgs("RAGVT5.yml"), "-d", cfgs("Synthetic.yml"), "n_val_docs=8",
                               "max_new_tokens=16", "--noise-pages", "0", "3", "--seeds", "0", "1"])
    summary["noise_experiment_s"] = time.perf_counter() - t0
    launches["noise_experiment"] = dict(kernels.LAUNCHES)
    lines = [json.loads(x) for x in out.getvalue().strip().splitlines()]
    summary["noise_experiment"] = lines
    log(f"  noise_experiment, 8 documents, noise 0 and 3 pages, seeds 0 and 1: {summary['noise_experiment_s']:.1f} s; "
        f"{lines}")
    if [x["noise_pages"] for x in lines] != [0, 3] or set(res) != {0, 3}:
        raise AssertionError(f"noise_experiment: {lines}")
    check_launched(launches["noise_experiment"], TOWER_KERNELS, "noise_experiment")
    return launches, summary


def check_dkv16(checks: Checks, g: torch.Generator) -> None:
    """12f: the answer-quality model's f32 shapes (11a's), timed: K2 and K6
    at B 8 H 4 T 128 d_kv 16 with the shared bias, each beside SDPA in f32
    (the backward through autograd), and K3 over 12 f32 caches of Te 128
    beside SDPA with a query length of 1, by events and on the device."""
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    f32 = torch.float32
    lens = [AQ_T - 9 * b for b in range(AQ_B)]
    tag = f"B{AQ_B} H{AQ_H} T{AQ_T} dk{AQ_DK} shared bias t5-mask f32 (answer-quality model)"
    flash_case(checks, g, AQ_B, AQ_T, AQ_H, AQ_H, AQ_DK, f32, "shared", False, 1.0, fe.T5_MASK_VALUE, lens, tag,
               timed=True, device=True)
    flash_bwd_case(checks, g, AQ_B, AQ_T, AQ_H, AQ_H, AQ_DK, f32, "shared", False, 1.0, fe.T5_MASK_VALUE, lens, tag,
                   timed=True)
    layers = [decode_inputs(g, AQ_B, AQ_H, AQ_DK, AQ_T, f32, lens) for _ in range(12)]
    time_decode_layers(checks, f"B{AQ_B} H{AQ_H} dk{AQ_DK} Te{AQ_T} f32 cache (answer-quality model)", layers,
                       library=True, dtype=f32)
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phase 13: the causal-LM family (Qwen2.5-VL-7B RAG serving, the Gemma LLM
# reranker on K2's dh-256 form, the Qwen2.5-VL tower, LoRA SFT on K2/K6)
# --------------------------------------------------------------------------- #
# Qwen2.5-VL-7B's language model (bench.py:803-806) and its vision tower; the
# Gemma-2b backbone of bge-reranker-v2-gemma as the config keys of build_reranker
QWEN7B = dict(vocab_size=152064, d_model=3584, num_layers=28, num_heads=28, num_kv_heads=4, d_ff=18944,
              tie_word_embeddings=False)
QWEN7B_VISION = dict(hidden_size=1280, intermediate_size=3420, num_heads=16, depth=32, out_hidden_size=3584,
                     window_size=112, fullatt_block_indexes=(7, 15, 23, 31), image_size=112)
GEMMA_RERANK = {"reranker_weights": "BAAI/bge-reranker-v2-gemma", "reranker_d_model": 2048,
                "reranker_num_layers": 18, "reranker_num_heads": 8, "reranker_num_kv_heads": 1,
                "reranker_head_dim": 256, "reranker_d_ff": 16384,
                "rerank_pair_len": 192, "rerank_filter_tresh": 0.4}
GEMMA_VOCAB = 256000
QW_B, QW_DOCS_PAGES, QW_WORDS = 8, 8, 120  # bench.py:779-787's documents
LORA_B, LORA_T = 4, 512 + 24  # max_prompt_tokens + answer_max_tokens
GLUE_KERNELS = ("lm_add_rms_norm", "lm_bias_rope", "lm_glu")
CAUSAL_LM_KERNELS = ("flash_fwd",) + GLUE_KERNELS
LORA_KERNELS = ("flash_fwd", "flash_bwd")
QWEN_CLI_CONF_RTOL = 1e-4  # 13g: a confidence on the card against the CPU's, f32 on both


def causal_pairs(lens, T: int) -> int:
    """(query, key) pairs a causal pass with right-padded keys needs: every
    query row t takes the keys k <= t that are valid (k < len)."""
    return sum(min(t + 1, int(n)) for n in lens for t in range(T))


def causal_mask_bool(lens, T: int, dev) -> torch.Tensor:
    """(B, 1, T, T) bool: key k for query t when k <= t and k < len."""
    km = key_mask(lens, T, dev)
    tri = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    return tri[None, None] & km[:, None, None, :]


def causal_flash_case(checks: Checks, g: torch.Generator, unit: str, B, T, H, Hkv, dh, dtype, lens, label,
                      timed=False) -> None:
    """K2 causal GQA with a right-padded key mask against its plain version
    (out and lse of every row: each has key 0), a second launch's bits;
    `timed`: beside SDPA with `enable_gqa` and the combined causal and
    padding mask, the bound counting the pairs this data needs. `unit`
    names the form (flash_fwd, or flash_fwd_dh256 above dh 128)."""
    import torch.nn.functional as F

    from rag_docvqa_tpu_torch.ops import flash_attention as fa

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    q, k, v = randn(B, T, H, dh).to(dtype), randn(B, T, Hkv, dh).to(dtype), randn(B, T, Hkv, dh).to(dtype)
    mask, scale = key_mask(lens, T, dev), dh**-0.5
    run = lambda: fa.flash_attention_fwd(q, k, v, mask, None, scale, True)
    got, glse = run()
    want, wlse = fa.flash_attention_reference(q, k, v, mask, None, scale, True)
    checks.compare(unit, f"{label} out", got, want, tol(dtype, want))
    checks.compare(unit, f"{label} lse", glse, wlse, tol(dtype, wlse))
    again, alse = run()
    if not (torch.equal(got, again) and torch.equal(glse, alse)):
        raise AssertionError(f"{unit} {label}: a second launch on the same input gave other bits")
    if timed:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        attn = causal_mask_bool(lens, T, dev)
        checks.timed(unit, label, run, lambda: fa.flash_attention_reference(q, k, v, mask, None, scale, True),
                     library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn, scale=scale,
                                                                    enable_gqa=True),
                     library_is="F.scaled_dot_product_attention, enable_gqa, the causal and padding mask as one "
                                "bool (B, 1, T, T) mask",
                     io_bytes=nbytes(q, k, v, mask, got, glse), ops=4.0 * H * dh * causal_pairs(lens, T),
                     ops_in=op_type(dtype), device=True)


def causal_flash_bwd_case(checks: Checks, g: torch.Generator, B, T, H, Hkv, dh, dtype, lens, label,
                          timed=False) -> None:
    """K6 causal GQA against its plain version from the same forward; `timed`:
    a second launch's bits, beside autograd through SDPA (enable_gqa, the
    combined bool mask), the bound counting the needed pairs."""
    import torch.nn.functional as F

    from rag_docvqa_tpu_torch.ops import flash_attention as fa

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    q, do = randn(B, T, H, dh).to(dtype), randn(B, T, H, dh).to(dtype)
    k, v = randn(B, T, Hkv, dh).to(dtype), randn(B, T, Hkv, dh).to(dtype)
    mask, scale = key_mask(lens, T, dev), dh**-0.5
    args = (mask, None, scale, True)
    out, lse = fa.flash_attention_reference(q, k, v, *args)
    out = out.contiguous()
    bwd = lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
    got = bwd()
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, *args)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        checks.compare("flash_bwd", f"{label} {name}", a, b, rel_tol(dtype, b))
    if not timed:
        return
    if not all(torch.equal(a, b) for a, b in zip(got[:3], bwd()[:3])):
        raise AssertionError(f"flash_bwd {label}: a second launch on the same input gave other bits")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=causal_mask_bool(lens, T, dev), scale=scale,
                                       enable_gqa=True)
    library = lambda: torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)
    backend = kernel_names(library)
    checks.timed("flash_bwd", label, bwd, lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, *args),
                 library=library, library_is="autograd.grad through F.scaled_dot_product_attention (enable_gqa, "
                                             "the bool causal and padding mask): " + backend,
                 io_bytes=nbytes(q, k, v, out, lse, do, mask, *got[:3]), ops=10.0 * H * dh * causal_pairs(lens, T),
                 ops_in=op_type(dtype), device=True)


def check_causal_kernels(checks: Checks, g: torch.Generator) -> None:
    """13a: K2 causal GQA at the Qwen2.5-VL-7B prefill shape (B 8 H 28 Hkv 4
    T 512 dh 128, ragged right-padded prompts), K2 at dh 256 (the Gemma
    reranker's B 320 H 8 Hkv 1 T 192, ragged pair lengths, bf16 and f32, and
    its tile edges), K6 causal GQA at the LoRA shape (B 4 H 28 Hkv 4 T 536),
    each against its plain version; the path shapes timed beside SDPA."""
    bf, f32 = torch.bfloat16, torch.float32
    prompt_lens = [512 - 37 * i for i in range(QW_B)]
    causal_flash_case(checks, g, "flash_fwd", QW_B, 512, 28, 4, 128, bf, prompt_lens,
                      "Qwen2.5-7B prefill B8 H28 Hkv4 T512 dh128 causal ragged bf16", timed=True)
    causal_flash_case(checks, g, "flash_fwd", 2, 512, 28, 4, 128, f32, prompt_lens[:2],
                      "Qwen2.5-7B prefill B2 H28 Hkv4 T512 dh128 causal ragged f32")
    pair_lens = [192 - (i * 37) % 120 for i in range(320)]
    for dtype, tag in ((bf, "bf16"), (f32, "f32")):
        causal_flash_case(checks, g, "flash_fwd_dh256", 320, 192, 8, 1, 256, dtype, pair_lens,
                          f"Gemma reranker B320 H8 Hkv1 T192 dh256 causal ragged {tag}", timed=True)
        for B, T, H, Hkv, dh in ((3, 63, 8, 1, 256), (3, 65, 8, 2, 256), (2, 129, 8, 1, 200), (2, 129, 4, 2, 256)):
            causal_flash_case(checks, g, "flash_fwd_dh256", B, T, H, Hkv, dh, dtype, [T - 17 * i for i in range(B)],
                              f"edge B{B} T{T} H{H} Hkv{Hkv} dh{dh} causal {tag}")
    lora_lens = [LORA_T - 23 * i for i in range(LORA_B)]
    causal_flash_bwd_case(checks, g, LORA_B, LORA_T, 28, 4, 128, bf, lora_lens,
                          f"LoRA B{LORA_B} H28 Hkv4 T{LORA_T} dh128 causal ragged bf16", timed=True)
    causal_flash_bwd_case(checks, g, 2, LORA_T, 28, 4, 128, f32, lora_lens[:2],
                          f"LoRA B2 H28 Hkv4 T{LORA_T} dh128 causal ragged f32")
    torch.cuda.empty_cache()


def check_lm_glue(checks: Checks, g: torch.Generator) -> None:
    """13a, the glue: residual add + RMSNorm, q/k/v biases + M-RoPE, and the
    SwiGLU product at the Qwen2.5-VL-7B cell's prefill (B 32 x T 2304) and
    decode (B 32 x T 1) shapes against their plain versions, the rotary and
    the product bit for bit, the norm within an ulp of its largest value;
    timed beside the plain ops, with the device times."""
    from rag_docvqa_tpu_torch.models import causal_lm as clm
    from rag_docvqa_tpu_torch.ops import lm_glue as lg

    dev, bf = g.device, torch.bfloat16
    randn = lambda *s, scale=1.0: (scale * torch.randn(s, generator=g, device=dev)).to(bf)
    cfg = clm.CausalLMConfig(**QWEN7B, mrope_section=(16, 24, 24))  # Qwen2.5-VL-7B's LM
    for B, T in ((32, 2304), (32, 1)):
        rows, tag = B * T, "prefill" if T > 1 else "decode"
        x, dx, w = randn(rows, 3584, scale=4.0), randn(rows, 3584, scale=2.0), 1.0 + randn(3584, scale=0.2)
        got, want = lg.add_rms_norm(x, dx, w, 1e-6), lg.add_rms_norm_reference(x, dx, w, 1e-6)
        checks.compare("lm_add_rms_norm", f"{tag} {rows}x3584 residual sum", got[0], want[0], 0.0)
        checks.compare("lm_add_rms_norm", f"{tag} {rows}x3584 norm", got[1], want[1],
                       want[1].float().abs().max().item() * 2.0**-7)
        checks.timed("lm_add_rms_norm", f"Qwen2.5-VL-7B {tag} {rows}x3584 residual bf16",
                     lambda: lg.add_rms_norm(x, dx, w, 1e-6), lambda: lg.add_rms_norm_reference(x, dx, w, 1e-6),
                     io_bytes=nbytes(x, dx, x, x, w), device=True)
        del x, dx, got, want
        q, k, v = randn(B, T, 28, 128, scale=3.0), randn(B, T, 4, 128, scale=3.0), randn(B, T, 4, 128, scale=3.0)
        biases = [randn(n * 128) for n in (28, 4, 4)]
        pos = torch.arange(T, device=dev).repeat(3, B, 1) + (2304 if T == 1 else 0)
        pos[1:] += torch.randint(0, 16, (2, B, T), generator=g, device=dev)  # (t, h, w) apart, as on crop tokens
        cos, sin = clm.mrope_frequencies(cfg, pos)
        want = lg.bias_rope_reference(q, k, v, *biases, cos, sin)
        lg.bias_rope_(q, k, v, *biases, cos, sin)
        for name, a, b in zip("qkv", (q, k, v), want):
            checks.compare("lm_bias_rope", f"{tag} B{B} T{T} {name}", a, b, 0.0)
        checks.timed("lm_bias_rope", f"Qwen2.5-VL-7B {tag} B{B} T{T} H28 Hkv4 hd128 M-RoPE biases bf16",
                     lambda: lg.bias_rope_(q, k, v, *biases, cos, sin),
                     lambda: lg.bias_rope_reference(q, k, v, *biases, cos, sin),
                     io_bytes=2 * nbytes(q, k, v) + nbytes(*biases, cos, sin), device=True)
        del q, k, v, want
        gate, up = randn(rows, 18944, scale=3.0), randn(rows, 18944)
        checks.compare("lm_glu", f"{tag} {rows}x18944 silu", lg.glu(gate, up, "silu"),
                       lg.glu_reference(gate, up, "silu"), 0.0)
        checks.timed("lm_glu", f"Qwen2.5-VL-7B {tag} {rows}x18944 SwiGLU bf16", lambda: lg.glu(gate, up, "silu"),
                     lambda: lg.glu_reference(gate, up, "silu"), io_bytes=3 * nbytes(gate), device=True)
        del gate, up
        torch.cuda.empty_cache()


class plain_attention:
    """Within it, models/causal_lm.py's causal attention is the plain
    `attention_reference` instead of K2/K6 (autograd through plain torch)."""

    def __enter__(self):
        from rag_docvqa_tpu_torch.models import causal_lm as clm
        from rag_docvqa_tpu_torch.ops import flash_attention as fa

        self.saved = clm.flash_attention
        clm.flash_attention = lambda q, k, v, key_mask=None, causal=False, scale=1.0: fa.attention_reference(
            q, k, v, key_mask=key_mask, causal=causal, scale=scale)

    def __exit__(self, *exc):
        from rag_docvqa_tpu_torch.models import causal_lm as clm

        clm.flash_attention = self.saved


def check_causal_stack(g: torch.Generator) -> dict:
    """13b: the full-width f32 `forward_hidden` at 4 layers of the 7B widths
    and 2 of the Gemma widths (depth cut), through K2 against the plain
    attention on the card, at the valid positions (a padded row attends to
    key 0 in both, but is not compared); then the f32 LoRA gradient at 2
    layers of the 7B widths, through K2/K6 against autograd through the plain
    attention, with nonzero b factors."""
    from rag_docvqa_tpu_torch.models import causal_lm as clm
    from rag_docvqa_tpu_torch.models.lora import init_lora, merge_lora

    dev = g.device
    out = {}
    for name, cfg, L, B, T in (("qwen2.5-7b", clm.CausalLMConfig(**{**QWEN7B, "num_layers": 4}), 4, 2, 512),
                               ("gemma-2b", clm.CausalLMConfig(vocab_size=GEMMA_VOCAB, d_model=2048, num_layers=2,
                                                               num_heads=8, num_kv_heads=1, d_ff=16384,
                                                               rope_theta=1e4, qkv_bias=False, arch="gemma",
                                                               head_dim_override=256), 2, 16, 192)):
        params = clm.init_causal_lm_params(g, cfg)
        ids = torch.randint(3, cfg.vocab_size, (B, T), generator=g, device=dev)
        mask = key_mask([T - (i * 53) % (T // 2) for i in range(B)], T, dev)
        with torch.no_grad():
            got = clm.forward_hidden(params, cfg, ids, mask)
            with plain_attention():
                want = clm.forward_hidden(params, cfg, ids, mask)
        torch.cuda.synchronize()
        err = (got - want).abs()[mask].max().item()
        limit = rel_tol(torch.float32, want[mask])
        log(f"  forward_hidden f32 {name} {L} layers B{B} T{T}: max abs err {err:.3e} at valid positions "
            f"(limit {limit:.1e}, max|ref| {want[mask].abs().max().item():.3g})")
        if not err <= limit:
            raise AssertionError(f"forward_hidden {name}: {err} above {limit}")
        out[f"forward_hidden_{name}_max_abs_err"] = err
        del params, got, want
        torch.cuda.empty_cache()
    cfg = clm.CausalLMConfig(**{**QWEN7B, "num_layers": 2})
    params = clm.init_causal_lm_params(g, cfg)
    lora = init_lora(g, params, rank=8)
    with torch.no_grad():
        for p in lora.parameters():
            if p.abs().max() == 0:
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.01)
    B, T = 2, 256
    ids = torch.randint(3, cfg.vocab_size, (B, T), generator=g, device=dev)
    mask = key_mask([T, T - 61], T, dev)
    labels = torch.where(mask, ids, -100)
    labels[:, :100] = -100
    grads = []
    for plain in (False, True):
        ctx = plain_attention() if plain else contextlib.nullcontext()
        with ctx:
            loss = clm.sft_loss(merge_lora(params, lora), cfg, ids, mask, labels)
            grads.append(torch.autograd.grad(loss, list(lora.parameters())))
    worst = 0.0
    for a, b in zip(*grads):
        err, limit = (a - b).abs().max().item(), rel_tol(torch.float32, b)
        worst = max(worst, err / limit)
        if not err <= limit:
            raise AssertionError(f"LoRA gradient through K2/K6: {err} above {limit}")
    log(f"  LoRA gradient f32, 7B widths 2 layers B{B} T{T}: worst error {worst:.3f} of its limit over "
        f"{len(grads[0])} adapter tensors")
    out["lora_grad_worst_share_of_limit"] = worst
    del params, lora, grads
    torch.cuda.empty_cache()
    return out


def qwen_documents(seed: int, n: int, images: bool = False):
    """bench.py:779-787's documents: n x 8 pages x 120 words, with one
    seeded 256 x 256 page image a page when asked for."""
    import numpy as np

    from rag_docvqa_tpu_torch.data.synthetic import make_corpus

    docs = make_corpus(n, n_pages=QW_DOCS_PAGES, words_per_page=QW_WORDS, seed=seed)
    if images:
        rng = np.random.RandomState(seed)
        for d in docs:
            d.images = [rng.randint(0, 255, (256, 256, 3)).astype(np.uint8) for _ in d.words]
    return docs


def weight_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in params.state_dict().values())


def serve_qwen(g: torch.Generator):
    """13c and 13d: Qwen2.5-VL-7B's language model in bf16 from
    `build_engine`; two served batches of 8 documents (stages, decode ms a
    step, the weight-read rate, K2 launches: 28 a batch); `generate` at B 32
    Tp 512 and 64 new tokens; the visual path with the Qwen2.5-VL-7B tower
    (112-px crops, 4 a sample) and once with the stand-in tower through K14.
    Returns (launches by path, summary, and for 13f the bf16 params, the
    tokenizer and the ingestor)."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.config import build_engine
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_qwen import QwenRAGConfig, RAGQwenEngine
    from rag_docvqa_tpu_torch.models import causal_lm as clm
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    dev = g.device
    tok = HashTokenizer(vocab_size=QWEN7B["vocab_size"])
    # the untied head comes from the parameters, not from a config key
    config = {"model_name": "Qwen", **{k: v for k, v in QWEN7B.items() if k not in ("vocab_size", "tie_word_embeddings")}}
    t0 = time.perf_counter()
    params = clm.init_causal_lm_params(g, clm.CausalLMConfig(**QWEN7B), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    wbytes = weight_bytes(params)
    log(f"  Qwen2.5-7B bf16 weights: {wbytes / 1e9:.2f} GB, made in {time.perf_counter() - t0:.1f} s")
    engine = build_engine(config, params, tok)
    assert isinstance(engine, RAGQwenEngine) and engine.cfg == QwenRAGConfig() and engine.lm_cfg == \
        clm.CausalLMConfig(**QWEN7B), (engine.cfg, engine.lm_cfg)
    ingestor = DocVQAIngestor(tok, ChunkSpec(chunk_size=60, overlap=10), Caps(max_pages=8, max_chunks=32,
                                                                               max_slots=2048))
    batches = [ingestor.ingest(qwen_documents(SEED + 13 + i, QW_B)) for i in range(3)]
    engine.inference(*batches[0])  # warmup, not counted
    torch.cuda.synchronize()
    summary, launches = {"weights_gb": wbytes / 1e9}, {}
    kernels.reset_launch_counts()
    rows = []
    for batch, aux in batches[1:]:
        t0 = time.perf_counter()
        out = engine.inference(batch, aux)
        wall = time.perf_counter() - t0
        conf = out["confidences"]
        # random weights over a 152,064-token vocabulary: a product of 15 max-probabilities may underflow to 0
        if len(out["pred_answers"]) != QW_B or not all(math.isfinite(c) and 0.0 <= c <= 1.0 + 1e-6 for c in conf):
            raise AssertionError(f"Qwen serving: bad answers or confidences {conf}")
        t = {k: v * 1e3 for k, v in out["timings"].items()}
        step_ms = t["decode_s"] / (engine.cfg.max_new_tokens - 1)
        rows.append({"wall_ms": wall * 1e3, **{k.replace("_s", "_ms"): v for k, v in t.items()},
                     "decode_step_ms": step_ms, "weight_read_tb_per_s": wbytes / (step_ms / 1e3) / 1e12})
        log(f"  batch of {QW_B}: {wall * 1e3:.1f} ms wall; " + ", ".join(f"{k} {v:.2f} ms" for k, v in t.items())
            + f"; decode {step_ms:.2f} ms a step, weights read at {rows[-1]['weight_read_tb_per_s']:.3f} TB/s "
              f"(of 3.35)")
    launches["qwen_serve"] = dict(kernels.LAUNCHES)
    check_launched(launches["qwen_serve"], CAUSAL_LM_KERNELS, "Qwen serving")
    if launches["qwen_serve"]["flash_fwd"] != 28 * 2:
        raise AssertionError(f"Qwen serving launched K2 {launches['qwen_serve']['flash_fwd']} times, not 28 x 2")
    summary["serve"] = {"batches": rows, "k2_launches_per_batch": launches["qwen_serve"]["flash_fwd"] / 2,
                        "ms_per_batch": sum(r["wall_ms"] for r in rows) / len(rows)}
    # the decode step's launches, from its CUDA graph
    lm_cfg = engine.lm_cfg
    ids = torch.randint(3, 152000, (QW_B, 512), generator=g, device=dev)
    am = torch.ones_like(ids, dtype=torch.bool)
    with torch.inference_mode():
        _, cache = clm.prefill(params, lm_cfg, ids, am, 512 + 16)
        tok0 = torch.zeros(QW_B, dtype=torch.long, device=dev)
        step_mask = torch.ones(QW_B, 512 + 16, dtype=torch.bool, device=dev)
        pos = torch.full((QW_B,), 512, dtype=torch.long, device=dev)
        nodes = graph_nodes(lambda: clm.decode_step(params, lm_cfg, cache, tok0, 512, step_mask, rope_pos=pos))
    summary["decode_step_graph_nodes"] = len(nodes)
    log(f"  one decode step at B{QW_B} launches {len(nodes)} kernels (its CUDA graph's nodes)")
    del cache
    # generate at B 32 x Tp 512, 64 new tokens; then the int8 tree at B 8 below (13c)
    gen = {}
    for B in (32,):
        ids = torch.randint(3, 152000, (B, 512), generator=g, device=dev)
        am = torch.ones_like(ids, dtype=torch.bool)
        with torch.inference_mode():
            clm.generate(params, lm_cfg, ids, am, 64)
            tm = {}
            clm.generate(params, lm_cfg, ids, am, 64, timings=tm)
        step_ms = tm["decode_s"] * 1e3 / 63
        gen[f"bf16_B{B}"] = {"prefill_ms": tm["prefill_s"] * 1e3, "decode_step_ms": step_ms,
                             "prefill_tokens_per_s": B * 512 / tm["prefill_s"],
                             "weight_read_tb_per_s": wbytes / (step_ms / 1e3) / 1e12}
        log(f"  generate bf16 B{B} Tp512 +64: prefill {tm['prefill_s'] * 1e3:.1f} ms, decode {step_ms:.2f} ms a "
            f"step ({gen[f'bf16_B{B}']['weight_read_tb_per_s']:.3f} TB/s of weights)")
    # 13d: the visual path, Qwen2.5-VL-7B's tower, f32 (the tower computes in the pixels' dtype, as in JAX)
    from rag_docvqa_tpu_torch.models import qwen25_vision as q25
    from rag_docvqa_tpu_torch.models import qwen_vision as qv
    from rag_docvqa_tpu_torch.models.vit import ViTConfig

    vcfg = q25.Qwen25VisionConfig(**QWEN7B_VISION)
    vparams = q25.init_qwen25_vision_params(g, vcfg)
    vis_engine = RAGQwenEngine(QwenRAGConfig(use_visual=True, max_crops=4), lm_cfg, params, tok, vision_cfg=vcfg,
                               vision_params=vparams)
    vis_batches = [ingestor.ingest(qwen_documents(SEED + 130 + i, QW_B, images=True)) for i in range(2)]
    vis_engine.inference(*vis_batches[0])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = vis_engine.inference(*vis_batches[1])
    wall = time.perf_counter() - t0
    launches["qwen_visual_serve"] = dict(kernels.LAUNCHES)
    check_launched(launches["qwen_visual_serve"], CAUSAL_LM_KERNELS, "Qwen visual serving")
    px = torch.randn(QW_B * 4, 112, 112, 3, generator=g, device=dev)
    with torch.inference_mode():
        tower_ms = time_ms(lambda: q25.encode_image(vparams, vcfg, px), iters=3, warmup=1)
    t = {k: v * 1e3 for k, v in out["timings"].items()}
    summary["visual_serve"] = {"wall_ms": wall * 1e3, **{k.replace("_s", "_ms"): v for k, v in t.items()},
                               "tower_ms_32_crops": tower_ms}
    log(f"  visual batch of {QW_B} (4 crops of 112 px a sample, Qwen2.5-VL-7B tower f32): {wall * 1e3:.1f} ms; "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in t.items()) + f"; the tower alone on 32 crops {tower_ms:.2f} ms")
    del vparams, vis_engine
    scfg = qv.QwenVisionConfig(vit=ViTConfig(), out_dim=QWEN7B["d_model"])
    sparams = qv.init_qwen_vision_params(g, scfg).to(torch.bfloat16)
    stand_in = RAGQwenEngine(QwenRAGConfig(use_visual=True, max_crops=4), lm_cfg, params, tok, vision_cfg=scfg,
                             vision_params=sparams)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = stand_in.inference(*vis_batches[1])
    launches["qwen_stand_in_tower_serve"] = dict(kernels.LAUNCHES)
    check_launched(launches["qwen_stand_in_tower_serve"], CAUSAL_LM_KERNELS + VIT_KERNELS, "stand-in tower serving")
    summary["stand_in_tower_serve_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"  the stand-in tower (ViT-base 224 px through K14, bf16): {summary['stand_in_tower_serve_ms']:.1f} ms a "
        f"batch; launches {launches['qwen_stand_in_tower_serve']}")
    del sparams, stand_in
    summary["generate"] = gen
    torch.cuda.empty_cache()
    return launches, summary, params, tok, ingestor


def generate_int8(g: torch.Generator) -> dict:
    """13c, last part: `generate` at B 8 Tp 512 and 64 new tokens on
    `init_causal_lm_params_int8` weights at the 7B widths (bench.py:793-820);
    the int8 tree serves `generate` only, as in JAX."""
    from rag_docvqa_tpu_torch.models import causal_lm as clm

    cfg = clm.CausalLMConfig(**QWEN7B)
    params = clm.init_causal_lm_params_int8(g, cfg)
    wbytes = weight_bytes(params)
    ids = torch.randint(3, 152000, (QW_B, 512), generator=g, device=g.device)
    am = torch.ones_like(ids, dtype=torch.bool)
    with torch.inference_mode():
        tokens, conf = clm.generate(params, cfg, ids, am, 64)
        tm = {}
        clm.generate(params, cfg, ids, am, 64, timings=tm)
    if not bool(torch.isfinite(conf).all()) or tokens.shape != (QW_B, 64):
        raise AssertionError(f"int8 generate: tokens {tuple(tokens.shape)}, confidences {conf.tolist()}")
    step_ms = tm["decode_s"] * 1e3 / 63
    log(f"  generate int8 weights ({wbytes / 1e9:.2f} GB) B{QW_B} Tp512 +64: prefill {tm['prefill_s'] * 1e3:.1f} ms, "
        f"decode {step_ms:.2f} ms a step ({wbytes / (step_ms / 1e3) / 1e12:.3f} TB/s of int8 weights)")
    del params
    torch.cuda.empty_cache()
    return {"weights_gb": wbytes / 1e9, "prefill_ms": tm["prefill_s"] * 1e3, "decode_step_ms": step_ms,
            "weight_read_tb_per_s": wbytes / (step_ms / 1e3) / 1e12}


def lora_sft(g: torch.Generator, params, tok, ingestor, steps: int = 8):
    """13f: LoRA SFT at the 7B widths: the bf16 base frozen, f32 adapters of
    rank 8 on q and v, B 4 x T 536 from `build_sft_batch`, lr 1e-4, 8 steps on
    the one batch; the loss must fall. Step time split into the forward
    (through K2), the backward (through K6) and the update; peak memory;
    K2 and K6 launches (28 each a step)."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.engine.rag_qwen import QwenRAGConfig, RAGQwenEngine
    from rag_docvqa_tpu_torch.models import causal_lm as clm
    from rag_docvqa_tpu_torch.models.lora import init_lora, lora_param_count, merge_lora
    from rag_docvqa_tpu_torch.training.optimizer import Optimizer

    import numpy as np

    cfg = clm.CausalLMConfig(**QWEN7B)
    engine = RAGQwenEngine(QwenRAGConfig(), cfg, params, tok, embed_shared=params.embed)
    ids, mask, labels = engine.build_sft_batch(*ingestor.ingest(qwen_documents(SEED + 139, LORA_B)), seed=0)
    if ids.shape != (LORA_B, LORA_T):
        raise AssertionError(f"SFT batch {tuple(ids.shape)}, want ({LORA_B}, {LORA_T})")
    lora = init_lora(g, params, rank=8)
    opt = Optimizer(lr=1e-4, clip_norm=None, weight_decay=0.0, constant_lr=True)
    state = opt.init(lora)
    named = dict(lora.named_parameters())
    losses, rows = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        if i == 1:
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss = clm.sft_loss(merge_lora(params, lora), cfg, ids, mask, labels)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.update(named, grads, state)
        losses.append(loss.item())
        t3 = time.perf_counter()
        rows.append({"forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3, "update_ms": (t3 - t2) * 1e3})
        if i == 1:
            launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  LoRA SFT 7B bf16 base, r8 q/v ({lora_param_count(lora)} adapter values), B{LORA_B} T{LORA_T}: losses "
        f"{[round(x, 4) for x in losses]}; step (after the first) forward {np.mean([r['forward_ms'] for r in rows[1:]]):.1f} "
        f"ms, backward {np.mean([r['backward_ms'] for r in rows[1:]]):.1f} ms, update "
        f"{np.mean([r['update_ms'] for r in rows[1:]]):.2f} ms; peak {peak:.2f} GiB; one step's launches {launches}")
    check_launched(launches, LORA_KERNELS, "LoRA SFT")
    if launches["flash_fwd"] != 28 or launches["flash_bwd"] != 28:
        raise AssertionError(f"a LoRA step launched K2 {launches['flash_fwd']} and K6 {launches['flash_bwd']} times, "
                             "not 28 each")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"LoRA SFT loss did not fall: {losses}")
    del lora, state, grads
    torch.cuda.empty_cache()
    return launches, {"losses": losses, "steps": rows, "peak_gib": peak}


def serve_llm_reranked(g: torch.Generator):
    """13e: RAGVT5Engine.inference (phase 5's t5-base bf16 engine, B 32) with
    `build_reranker`'s gemma branch at bge-reranker-v2-gemma's Gemma-2b
    widths (vocabulary 256,000 from its tokenizer) in bf16: 320 pairs of
    T 192 a batch, 18 K2 launches at dh 256."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.config import build_reranker
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
    from rag_docvqa_tpu_torch.engine.reranker import FlagLLMReranker
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    tok = HashTokenizer(32128)
    ingestor = DocVQAIngestor(tok, ChunkSpec(chunk_size=60, overlap=10), Caps())
    docs = make_corpus(96, n_pages=8, words_per_page=120, seed=SEED + 13)
    ingestor.caps = ingestor.plan_caps(docs)
    batches = [ingestor.ingest(docs[i:i + 32]) for i in range(0, 96, 32)]
    vt5_cfg = vt5m.VT5Config(t5=t5m.T5Config(decode_kv_int8=True, fused_decode_attn=True))
    params = vt5m.init_vt5_params(g, vt5_cfg).to(torch.bfloat16)
    t0 = time.perf_counter()
    reranker = build_reranker(GEMMA_RERANK, HashTokenizer(GEMMA_VOCAB), seed=SEED + 13, device="cuda")
    reranker.params.to(torch.bfloat16)
    torch.cuda.synchronize()
    assert isinstance(reranker, FlagLLMReranker) and reranker.lm_cfg.head_dim == 256, reranker
    log(f"  Gemma-2b reranker weights {weight_bytes(reranker.params) / 1e9:.2f} GB bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    rcfg = reranker.cfg
    engine = RAGVT5Engine(RAGConfig(page_retrieval="concat", chunk_num=10, include_surroundings=0,
                                    max_source_length=512, max_new_tokens=16), vt5_cfg, params, tok, reranker=reranker)
    engine.inference(*batches[0])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    results = []
    for batch, aux in batches[1:]:
        t0 = time.perf_counter()
        out = engine.inference(batch, aux)
        results.append((out, (time.perf_counter() - t0) * 1e3))
    launches = dict(kernels.LAUNCHES)
    dh256 = kernels.FORM_LAUNCHES["flash_fwd_dh256"]
    rows = []
    for i, (out, wall) in enumerate(results):
        sims = torch.as_tensor(out["retrieval"]["similarities"])
        for b, pages in enumerate(out["pred_answer_pages"]):
            n, s = len(pages), sims[b]
            if not (rcfg.min_chunk_num <= n <= rcfg.max_chunk_num and bool(torch.isfinite(s[:n]).all())
                    and bool((s[:n - 1] >= s[1:n]).all()) and bool((s[:n] >= 0).all()) and bool((s[:n] <= 1).all())):
                raise AssertionError(f"LLM-reranked batch {i} doc {b}: {n} valid ranks with scores {s.tolist()}")
        rows.append({"wall_ms": wall, "rerank_ms": out["retrieval"]["rerank_time"] * 1e3})
        log(f"  batch {i}: {wall:.1f} ms wall, the Gemma reranker (320 pairs x T192, 18 layers) "
            f"{rows[-1]['rerank_ms']:.2f} ms; ranks kept {min(len(p) for p in out['pred_answer_pages'])}.."
            f"{max(len(p) for p in out['pred_answer_pages'])}")
    log(f"  launches in the two LLM-reranked batches: {launches}; K2 at dh 256: {dh256}")
    check_launched(launches, SERVE_KERNELS, "LLM-reranked serving")
    if dh256 != 18 * 2:
        raise AssertionError(f"the Gemma reranker launched K2 at dh 256 {dh256} times, not 18 x 2")
    launches["flash_fwd_dh256"] = dh256
    del reranker, engine, params
    torch.cuda.empty_cache()
    return launches, {"ms_per_batch": sum(r["wall_ms"] for r in rows) / len(rows),
                      "rerank_ms_per_batch": sum(r["rerank_ms"] for r in rows) / len(rows), "batches": rows,
                      "k2_dh256_launches_per_batch": dh256 / 2}


def qwen_clis() -> dict:
    """13g: the port's train_lora and eval entry points on
    configs/Qwen_tiny.yml on the card. The eval CLI runs on the card and on
    the CPU from the same (seeded) weights with the byte tokenizer (which
    decodes the generated ids into the answer), and each sample's predicted
    answer and pages must be equal on both, its confidence within
    QWEN_CLI_CONF_RTOL (f32 on both devices: the card's K2 and f32 GEMMs
    without TF32 against the CPU's plain attention and GEMMs)."""
    import contextlib
    import io

    from rag_docvqa_tpu_torch import eval as port_eval
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch import train_lora as port_lora

    import tempfile

    from rag_docvqa_tpu_torch.config import build_qwen_config, load_config, load_tokenizer
    from rag_docvqa_tpu_torch.train import init_params
    from rag_docvqa_tpu_torch.training.checkpoint import CheckpointManager
    from rag_docvqa_tpu_torch.training.train_step import TrainState

    model, data = os.path.join(REPO, "configs/Qwen_tiny.yml"), os.path.join(REPO, "configs/Synthetic.yml")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        port_lora.main(["-m", model, "-d", data])
    lora_s = time.perf_counter() - t0
    lora_launches = dict(kernels.LAUNCHES)
    line = [x for x in printed.getvalue().splitlines() if "sft_loss=" in x]
    log(f"  train_lora CLI: {line} ({lora_s:.1f} s); launches {lora_launches}")
    check_launched(lora_launches, LORA_KERNELS, "train_lora CLI")
    # the same weights on both devices: the config's seeded init on the CPU, as a checkpoint of the port's trainer;
    # the byte tokenizer decodes the ids that the LM chose into the answer (the hash tokenizer gives "" for them)
    config = load_config(model=model, dataset=data, overrides={"tokenizer": "byte"})
    weights = init_params(config, build_qwen_config(config, load_tokenizer(config.get("tokenizer")).vocab_size),
                          torch.device("cpu"), kind="qwen")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        CheckpointManager(tmp).save(0, TrainState(params=weights, opt_state={}, step=0))
        card_path, cpu_path = os.path.join(tmp, "card.json"), os.path.join(tmp, "cpu.json")
        t0 = time.perf_counter()
        card = port_eval.main(["-m", model, "-d", data, "--ckpt", tmp, "--save-path", card_path, "tokenizer=byte"])[0]
        eval_s = time.perf_counter() - t0
        cpu = port_eval.main(["-m", model, "-d", data, "--ckpt", tmp, "--device", "cpu", "--save-path", cpu_path,
                              "tokenizer=byte"])[0]
        samples = []
        for path in (card_path, cpu_path):
            with open(path) as f:
                samples.append(json.load(f)["scores_by_samples"])
    log(f"  eval CLI: card {card} ({eval_s:.1f} s); CPU {cpu}")
    on_card, on_cpu = samples
    if not (line and card["n_samples"] == cpu["n_samples"] == len(on_card) > 0 and on_card.keys() == on_cpu.keys()):
        raise AssertionError(f"Qwen CLIs: {line}, {card}, {cpu}")
    conf_err = 0.0
    for qid, a in on_card.items():
        b = on_cpu[qid]
        if (a["pred_answer"], a["pred_answer_pages"]) != (b["pred_answer"], b["pred_answer_pages"]):
            raise AssertionError(f"Qwen eval CLI, sample {qid}: {a['pred_answer']!r} page {a['pred_answer_pages']} "
                                 f"on the card, {b['pred_answer']!r} page {b['pred_answer_pages']} on the CPU")
        conf_err = max(conf_err, abs(a["pred_answer_conf"] - b["pred_answer_conf"])
                                 / max(abs(b["pred_answer_conf"]), 1e-30))
    log(f"  eval CLI: {len(on_card)} answers and pages equal on card and CPU; confidences within {conf_err:.2e} "
        f"relative (limit {QWEN_CLI_CONF_RTOL:.0e})")
    if not conf_err <= QWEN_CLI_CONF_RTOL:
        raise AssertionError(f"Qwen eval CLI: confidences {conf_err:.2e} apart relative on card and CPU")
    return {"train_lora": line[0], "train_lora_s": lora_s, "eval": card, "eval_s": eval_s,
            "eval_answers_compared": len(on_card), "eval_conf_max_rel_diff": conf_err,
            "train_lora_launches": lora_launches}


# --------------------------------------------------------------------------- #
# phase 14: the multi-device layer through process groups
# --------------------------------------------------------------------------- #
# 9f's indexed shape for the sharded MaxSim: 32 documents x 16 patch sets of 128 patches, D 768, a 128-token query
MS_N, MS_TP, MS_TQ, MS_D = 512, 128, 128, 768
# loss and grad norm of a world-size-1 group against the unsharded step, at every step: the same kernels on the
# same rows, the collectives over one rank, the norm summed in the leaves' order (bf16 copies of f32 masters
# amplify any difference: a norm summed in another order, 2 ulps off at the second step, put the fourth step's
# grad norm 5e-4 off on the H100)
GROUP_RTOL = 1e-6
# the kernels the dry run's sharded paths launch in each rank: the train steps, the index at B 8 (K4), MaxSim,
# the decode of evaluate and of the split rows (K3)
DRYRUN_KERNELS = TRAIN_KERNELS + ("decode_cross_attention", "topk_fused", "maxsim")


def group_index(g: torch.Generator, mesh) -> tuple:
    """14a: 7b's index through the data group (one shard on this rank)
    against the n_shards=1 form, every precision: ids equal, values within
    F32_TOL, resident bytes, queries per second at B 256 of both."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.parallel import ShardedIndex

    dev = g.device
    N, D, B, k = INDEX_N, INDEX_D, INDEX_B, INDEX_K
    emb = torch.randn((N, D), generator=g, device=dev)
    queries = torch.randn((B, D), generator=g, device=dev)
    launches, out = {}, {}
    for dtype, refine in (("f32", False), ("bf16", False), ("int8", False), ("int4", False), ("int4", True)):
        name = dtype + ("_refine" if refine else "")
        kw = dict(dtype=dtype, refine=refine, kernel="auto")
        one = ShardedIndex.build(emb, n_shards=1, **kw)
        grp = kernels.counted(launches, ShardedIndex.build, emb, mesh=mesh, **kw)
        got = [kernels.counted(launches, grp.query, q, k) for q in (queries, queries[:8])]  # B 8: the fused kernel K4
        want = [one.query(q, k) for q in (queries, queries[:8])]
        for (gv, gi, gok), (wv, wi, wok), b in zip(got, want, (B, 8)):
            gv, gi, wv, wi = (torch.as_tensor(x).to(dev) for x in (gv, gi, wv, wi))
            err = (gv - wv).abs().max().item()
            if not (torch.equal(gi.long(), wi.long()) and torch.equal(torch.as_tensor(gok), torch.as_tensor(wok))
                    and err <= F32_TOL):
                raise AssertionError(f"group index {name} B{b}: ids or validity differ, or values by {err}")
        forms = {"ranges": lambda: one.query(queries, k), "group": lambda: grp.query(queries, k)}
        ms = host_ms(forms, n=1, calls=20)
        log(f"  {name} B{B} query, host ms: {ms}")
        events = {f: time_ms(fn, iters=20) for f, fn in forms.items()} if not refine else None
        out[name] = {"resident_bytes_group": grp.resident_bytes, "resident_bytes_ranges": one.resident_bytes,
                     "query_ms_b256": ms, "queries_per_s_b256": {f: B / t * 1e3 for f, t in ms.items()},
                     "query_event_ms_b256": events}
        if grp.resident_bytes != one.resident_bytes:  # one rank: the whole padded index
            raise AssertionError(f"group index {name}: {grp.resident_bytes} resident bytes, ranges {one.resident_bytes}")
        log(f"  {name:12s} through the group: ids equal to the n_shards=1 form at B {B} and 8, resident "
            f"{grp.resident_bytes / 1e6:.1f} MB; B{B} {B / ms['group'] * 1e3:.0f} queries/s (n_shards=1 form "
            f"{B / ms['ranges'] * 1e3:.0f}); by CUDA events {events}")
        del one, grp
    check_launched(launches, INDEX_KERNELS, "group index")
    # the merge's collective alone: one all-gather of the (B, 2k) values and ids as f64
    packed = torch.randn((B, 2 * k), generator=g, device=dev, dtype=torch.float64)
    gather = lambda: mesh.all_gather(packed, "data")
    out["merge_all_gather_ms"] = {"events": time_ms(gather, iters=50), "host": host_ms(gather, n=2, calls=50)}
    log(f"  the merge's all-gather of ({B}, {2 * k}) f64 values and ids alone: {out['merge_all_gather_ms']} ms")
    return launches, out


def group_maxsim(g: torch.Generator, mesh) -> tuple:
    """14a: sharded MaxSim through the data group at 9f's indexed shape
    against late_interaction and a stable top-k over the whole index."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.ops import late_interaction as li
    from rag_docvqa_tpu_torch.parallel import sharded_maxsim_topk

    dev = g.device
    patches = torch.randn((MS_N, MS_TP, MS_D), generator=g, device=dev)
    pmask = torch.rand((MS_N, MS_TP), generator=g, device=dev) < 0.9
    q = torch.randn((MS_TQ, MS_D), generator=g, device=dev)
    n_valid, k, launches = MS_N - 5, 10, {}
    vals, idx, ok = kernels.counted(launches, sharded_maxsim_topk, patches, pmask, q, mesh=mesh, n_valid=n_valid,
                                    k=k)

    def whole():
        scores = li.late_interaction(q, patches, patch_mask=pmask)
        scores = torch.where(torch.arange(MS_N, device=dev) < n_valid, scores, float("-inf"))
        return torch.sort(scores, descending=True, stable=True)

    wv, wi = whole()
    plain = li.late_interaction_reference(q, patches, patch_mask=pmask)
    err, at_rows = (vals - wv[:k]).abs().max().item(), (plain[idx] - vals).abs().max().item()
    if not (torch.equal(idx, wi[:k]) and bool(ok.all()) and err <= F32_TOL and at_rows <= F32_TOL):
        raise AssertionError(f"group MaxSim: rows {idx.tolist()} against {wi[:k].tolist()}, {err}, {at_rows}")
    forms = {"whole": whole, "group": lambda: sharded_maxsim_topk(patches, pmask, q, mesh=mesh, n_valid=n_valid, k=k)}
    ms = host_ms(forms, n=1, calls=20)
    events = {f: time_ms(fn, iters=20) for f, fn in forms.items()}
    log(f"  MaxSim N{MS_N} Tp{MS_TP} Tq{MS_TQ} D{MS_D}, host ms: {ms}; by CUDA events: {events}")
    check_launched(launches, ("maxsim",), "group MaxSim")
    log(f"  sharded MaxSim through the group: rows equal to the whole index's top-{k}, values within {err:.1e}, "
        f"the plain scores at the rows within {at_rows:.1e}")
    return launches, {"ms": ms, "event_ms": events, "max_abs_err": max(err, at_rows),
                      "case": f"N{MS_N} Tp{MS_TP} Tq{MS_TQ} D{MS_D} f32"}


def group_evaluate(g: torch.Generator, mesh) -> tuple:
    """14a: data-parallel `evaluate` through the data group on phase 5's
    batch of 32 (t5-base bf16, int8 cross cache, K3 on) against the plain
    `evaluate`: answers and metrics equal; ms of each, and the object
    gather's share."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.evaluate import evaluate
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    tok = HashTokenizer(32128)
    ingestor = DocVQAIngestor(tok, ChunkSpec(chunk_size=60, overlap=10), Caps())
    docs = make_corpus(32, n_pages=8, words_per_page=120, seed=SEED)
    ingestor.caps = ingestor.plan_caps(docs)
    vt5_cfg = vt5m.VT5Config(t5=t5m.T5Config(decode_kv_int8=True, fused_decode_attn=True))
    params = vt5m.init_vt5_params(g, vt5_cfg).to(torch.bfloat16)
    engine = RAGVT5Engine(RAGConfig(page_retrieval="concat", chunk_num=10, include_surroundings=0,
                                    max_source_length=512, max_new_tokens=16), vt5_cfg, params, tok)
    gather_ms = []
    inner = mesh.all_gather_object

    def timed_gather(obj, axis):
        t0 = time.perf_counter()
        out = inner(obj, axis)
        gather_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    mesh.all_gather_object = timed_gather
    run = lambda m: evaluate(engine, docs, ingestor, batch_size=32, mesh=m)
    plain = run(None)  # warmup
    launches = {}
    grp = kernels.counted(launches, run, mesh)
    plain = run(None)
    if grp["pred_answers"] != plain["pred_answers"] or grp["n_samples"] != 32:
        raise AssertionError("group evaluate: answers differ from the plain evaluate")
    for key in ("accuracy", "anls", "retrieval_precision", "chunk_score"):
        if not abs(grp[key] - plain[key]) <= 1e-6:
            raise AssertionError(f"group evaluate: {key} {grp[key]} against {plain[key]}")
    gather_ms.clear()
    ms = host_ms({"plain": lambda: run(None), "group": lambda: run(mesh)}, n=1, calls=2)
    log(f"  evaluate, 32 documents, host ms: {ms}")
    del mesh.all_gather_object
    check_launched(launches, SERVE_KERNELS, "group evaluate")
    log(f"  group evaluate: answers and metrics equal to the plain evaluate; the object gather "
        f"{sum(gather_ms) / 4:.2f} ms an evaluate (four group runs: {gather_ms})")
    return launches, {"ms": ms, "object_gather_ms": sum(gather_ms) / 4,
                      "case": "t5-base bf16, int8 cross cache, K3 on, 32 documents of 8 pages, batch 32"}


def group_decode(g: torch.Generator, mesh) -> tuple:
    """14a: `greedy_decode_sharded` through the (1, 1) group at phase 5's
    decode (t5-base bf16, B 32, Te 512, int8 cross cache, K3 on, 16 steps),
    the split leaves stored as slices, against `greedy_decode` on the whole
    weights: ids and confidences equal."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.ops.decode import greedy_decode, greedy_decode_sharded
    from rag_docvqa_tpu_torch.parallel.mesh import shard_params
    from rag_docvqa_tpu_torch.training.train_step import vt5_param_spec

    dev, B, Te, T = g.device, 32, 512, 16
    cfg = t5m.T5Config(decode_kv_int8=True, fused_decode_attn=True)
    whole = t5m.init_t5_params(g, cfg).to(torch.bfloat16)
    spec = vt5_param_spec(whole)
    sliced = shard_params(copy.deepcopy(whole), spec, mesh)  # the same weights, held as this rank's slices
    enc = torch.randn((B, Te, cfg.d_model), generator=g, device=dev).bfloat16()
    mask = torch.arange(Te, device=dev)[None, :] < torch.randint(1, Te + 1, (B, 1), generator=g, device=dev)
    launches = {}
    toks, conf = kernels.counted(launches, greedy_decode_sharded, sliced, cfg, enc, mask, T, mesh=mesh, spec=spec)
    want_t, want_c = greedy_decode(whole, cfg, enc, mask, T)
    if not (torch.equal(toks, want_t) and torch.equal(conf, want_c)):
        raise AssertionError("group decode: ids or confidences differ from the replicated decode")
    ms = host_ms({"whole": lambda: greedy_decode(whole, cfg, enc, mask, T),
                  "group": lambda: greedy_decode_sharded(sliced, cfg, enc, mask, T, mesh=mesh, spec=spec)}, n=1)
    log(f"  greedy decode B{B} Te{Te} int8 cache, {T} steps, host ms: {ms}")
    check_launched(launches, ("decode_cross_attention",), "group decode")
    log(f"  greedy_decode_sharded through the group: ids and confidences equal to the replicated decode")
    return launches, {"ms": ms, "case": f"t5-base bf16 B{B} Te{Te} int8 cross cache, K3, {T} steps"}


def group_train(mesh, kind: str) -> tuple:
    """14a: the sharded train step through a (1, 1) group against the
    unsharded one from the same weights: 6d's VT5 step (t5-base, B 8) or
    10d's Hi-VT5 step (B 16 x 8 page slots), bf16 compute on f32 masters;
    loss and grad norm within GROUP_RTOL at every step; ms per step of
    each."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps, to_device
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig
    from rag_docvqa_tpu_torch.models import hivt5 as hm
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec
    from rag_docvqa_tpu_torch.parallel.mesh import shard_params
    from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
    from rag_docvqa_tpu_torch.training.train_step import (TrainState, make_hivt5_train_step, make_train_step,
                                                         vt5_param_spec)

    dev = mesh.device
    if kind == "vt5":
        ingestor = DocVQAIngestor(HashTokenizer(32128), ChunkSpec(chunk_size=60, overlap=10), Caps())
        docs = make_corpus(8, n_pages=8, words_per_page=120, seed=SEED)
        ingestor.caps = ingestor.plan_caps(docs)
        cfg, init = vt5m.VT5Config(), vt5m.init_vt5_params
        roots, opt_kw, steps, max_len = ("t5", "spatial"), dict(lr=2e-4, warmup_steps=2, total_steps=80), 6, 32
        rag = RAGConfig(page_retrieval="concat", chunk_num=10, include_surroundings=0, max_source_length=512)
        make = lambda opt, m: make_train_step(cfg, rag, opt, bf16_compute=True, mesh=m)
    else:
        ingestor = DocVQAIngestor(HashTokenizer(32128), ChunkSpec(chunk_size=60, overlap=10), Caps(max_pages=HI_P))
        docs = hivt5_documents(SEED + 12)
        cfg, init = hm.HiVT5Config(max_doc_pages=HI_P, page_tokens=HI_K, page_seq_len=HI_T), hm.init_hivt5_params
        roots, opt_kw, steps, max_len = ("t5", "spatial", "page_emb", "page_head"), dict(
            lr=1e-4, warmup_steps=10, total_steps=1000), 4, 16
        make = lambda opt, m: make_hivt5_train_step(cfg, opt, bf16_compute=True, mesh=m)
    batch, aux = ingestor.ingest(docs)
    labels = torch.from_numpy(ingestor.answer_labels(aux["answers"], max_len=max_len, seed=SEED)).to(dev)
    batch = to_device(batch, dev)
    rows, launches, runs = {"plain": [], "group": []}, {}, {}
    for form in ("plain", "group"):
        params = init(torch.Generator(device=dev).manual_seed(SEED + 14), cfg)  # f32 masters, the same in both
        if form == "group":
            shard_params(params, vt5_param_spec(params), mesh)
        opt = build_optimizer(**opt_kw, mask=trainable_mask(params, roots))
        runs[form] = [TrainState.create(params, opt), make(opt, mesh if form == "group" else None)]
    for i in range(steps):  # the two in turns, plain first on even steps
        for form in ("plain", "group") if i % 2 == 0 else ("group", "plain"):
            state, step = runs[form]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if form == "group":
                state, m = kernels.counted(launches, step, state, batch, labels)
            else:
                state, m = step(state, batch, labels)
            torch.cuda.synchronize()
            runs[form][0] = state
            rows[form].append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                               "ms": (time.perf_counter() - t0) * 1e3})
    del runs, state
    torch.cuda.empty_cache()
    worst = 0.0
    for i, (a, b) in enumerate(zip(rows["plain"], rows["group"])):
        log(f"  {kind} step {i}: unsharded {a}, group {b}")
        for key in ("loss", "grad_norm"):
            rel = abs(b[key] - a[key]) / abs(a[key])
            worst = max(worst, rel)
            if not rel <= GROUP_RTOL:
                raise AssertionError(f"group {kind} step {i}: {key} {b[key]} against the unsharded {a[key]}")
    check_launched(launches, TRAIN_KERNELS, f"group {kind} training")
    ms = {f: sum(r["ms"] for r in v[1:]) / (len(v) - 1) for f, v in rows.items()}
    log(f"  {kind} step through the group: loss and grad norm within {worst:.2e} of the unsharded step (limit "
        f"{GROUP_RTOL}); ms per step after the first: {ms}")
    return launches, {"ms": ms, "steps": rows, "max_rel_diff": worst}


def dryrun_on_one_card() -> tuple:
    """14b: `python -m rag_docvqa_tpu_torch.dryrun 2 --device cuda`, two
    ranks sharing the card through gloo; each rank's launches."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "rag_docvqa_tpu_torch.dryrun", "2", "--device", "cuda"], cwd=REPO,
                          capture_output=True, text=True, timeout=400)
    if proc.returncode != 0:
        raise AssertionError(f"dryrun 2 --device cuda failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    ranks = [json.loads(l) for l in lines if l.startswith('{"rank"')]
    if len(ranks) != 2 or not lines[-1].startswith("dryrun_multichip(2) OK:"):
        raise AssertionError(f"dryrun 2 --device cuda: unexpected output {lines[-4:]}")
    for r in ranks:
        if not (r["device"] == "cuda:0" and r["backend"] == "gloo"):
            raise AssertionError(f"dry run rank {r['rank']} on {r['device']} with {r['backend']}")
        check_launched(r["launches"], DRYRUN_KERNELS, f"dry run rank {r['rank']}")
    log(f"  {lines[0]}; {lines[-1]}; {time.perf_counter() - t0:.1f} s with its imports")
    return {f"dryrun_rank{r['rank']}": r["launches"] for r in ranks}, {"line": lines[-1],
                                                                       "s": time.perf_counter() - t0}


def multichip(card: str) -> tuple:
    """Phase 14: the group paths in a world-size-1 NCCL group (14a), then the
    dry run on two ranks sharing the card (14b)."""
    import tempfile

    import torch.distributed as dist

    from rag_docvqa_tpu_torch.parallel.mesh import create_mesh, init_with_store

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)  # its own data: the other phases' stay
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # the rendezvous is a file; no interface to look for
    launches, summary = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        init_with_store(os.path.join(tmp, "store"), 0, 1, "nccl", timeout_s=300)
        try:
            mesh = create_mesh((1, 1), ("data", "model"), device="cuda:0")
            data = create_mesh((1,), ("data",), device="cuda:0")
            log(f"phase 14a: the group paths through a world-size-1 {dist.get_backend()} group; card and power "
                f"limit: {card}")
            with torch.inference_mode():
                launches["group_index"], summary["index"] = group_index(g, data)
                torch.cuda.empty_cache()
                launches["group_maxsim"], summary["maxsim"] = group_maxsim(g, data)
                torch.cuda.empty_cache()
                launches["group_evaluate"], summary["evaluate"] = group_evaluate(g, data)
                torch.cuda.empty_cache()
                launches["group_decode"], summary["decode"] = group_decode(g, mesh)
                torch.cuda.empty_cache()
            launches["group_train"], summary["train"] = group_train(mesh, "vt5")
            launches["group_hivt5_train"], summary["hivt5_train"] = group_train(mesh, "hivt5")
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"phase 14b: the dry run, two ranks sharing the card (gloo); card and power limit: {card}")
    dry_launches, summary["dryrun"] = dryrun_on_one_card()
    launches.update(dry_launches)
    summary["s"] = time.perf_counter() - t0
    log(f"  phase 14: {summary['s']:.1f} s; card and power limit: {card}")
    return launches, summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rag_docvqa_tpu_torch import kernels

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"phase 1: card {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2
    t0 = time.perf_counter()
    kernels.library()
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s ({kernels.BUILD_DIR})")

    g = torch.Generator(device="cuda").manual_seed(SEED)
    checks = Checks()
    only = set(sys.argv[1:])  # e.g. `chip_smoke.py 8`: that phase alone, for work on it; no report
    if only - {"3", "4", "5", "6", "7", "8", "9", "10", "11", "12", "13", "14"}:
        raise SystemExit(f"usage: chip_smoke.py [phase ...], phases 3-14; got {sorted(only)}")
    want = lambda phase: not only or phase in only
    launches, path_launches = {}, {}
    if want("3") or want("4") or want("5"):
        with torch.inference_mode():
            if want("3"):
                log("phase 3: kernels against their plain versions")
                check_kernels(checks, g)
            if want("4"):
                log("phase 4: full-width f32 t5-base stack")
                check_stack(g)
                torch.cuda.empty_cache()
            if want("5"):
                log("phase 5: RAGVT5Engine.inference, concat, bf16 weights, int8 cross cache, decode kernel on")
                launches = serve(g)
                path_launches["serve"] = dict(launches)
                torch.cuda.empty_cache()
                # phase 5b draws from its own generator: the later phases' data stay as they were
                g5 = torch.Generator(device="cuda").manual_seed(SEED + 5)
                log(f"phase 5b: the ten strategies through RAGVT5Engine.inference, B {STRATEGY_B}, chunk_num "
                    f"{STRATEGY_K}, bf16, int8 cross cache, decode kernel on; card and power limit: {card}")
                strategy_launches, strategies = serve_strategies(g5)
                path_launches.update({f"serve_{k}": v for k, v in strategy_launches.items()})
                torch.cuda.empty_cache()
                log("phase 5b: K1, K2 and K3 at the per-chunk and page-row shapes")
                strategies["decode_splits"] = check_strategy_kernels(checks, g5)
                torch.cuda.empty_cache()
                log("phase 5b: the eval entry point, t5-base f32, 64 documents, maxconf, compute_stats")
                strategies["eval_cli"] = eval_cli()
    torch.cuda.empty_cache()
    if want("5"):
        log("phase 5b: t5-base VT5 train steps with the NAC term, bf16 compute, f32 masters")
        nac_launches, nac_summary = train_nac(g5)
        path_launches["train_nac"] = nac_launches
        torch.cuda.empty_cache()
    if want("6"):
        log("phase 6a: the flash backward (K6) against its plain version")
        check_flash_bwd(checks, g)
        log("phase 6b: the T5 layer backward (K7, K8) against their plain versions")
        check_layer_bwd(checks, g)
        torch.cuda.empty_cache()
        log("phase 6c: full-width f32 t5-base encoder gradient")
        encoder_grad = check_encoder_grad(g)
        torch.cuda.empty_cache()
        log("phase 6d: t5-base VT5 train steps, bf16 compute, f32 masters")
        train_launches, train_summary = train(g)
        path_launches["train"] = train_launches
        launches.update({k: train_launches[k] for k in KERNELS if KERNELS[k][2] == "train"})
        torch.cuda.empty_cache()
    if want("7"):
        with torch.inference_mode():
            log("phase 7a: the top-k kernels (K4, K5, K11, K12) against their plain versions")
            crossover = check_index_kernels(checks, g)
            torch.cuda.empty_cache()
            log(f"phase 7b: the resident index, N {INDEX_N} x D {INDEX_D}, B {INDEX_B}, k {INDEX_K}; "
                f"card and power limit: {card}")
            kernels.reset_launch_counts()
            index_summary = index_path(g)
            torch.cuda.empty_cache()
        log("phase 7c: precompute index | query on the synthetic corpus, t5-base width")
        index_summary["cli"] = index_cli()
        index_launches = dict(kernels.LAUNCHES)
        log(f"  launches in the index path (7b and 7c): {index_launches}")
        check_launched(index_launches, INDEX_KERNELS, "index")
        path_launches["index"] = index_launches
        launches.update({k: index_launches[k] for k in INDEX_KERNELS})
        index_summary["k4_against_plain"] = crossover.pop("k4_against_plain")
        index_summary["whole_function_ms"] = crossover
        torch.cuda.empty_cache()
    if want("8"):
        with torch.inference_mode():
            log("phase 8a: the BERT layer (K9) and its parts against their plain versions")
            check_bert_kernels(checks, g)
            log("phase 8b: full-width f32 bge-small stack")
            check_bert_stack(g)
            torch.cuda.empty_cache()
            log(f"phase 8c: embed -> index, bge-small bf16; card and power limit: {card}")
            embed_launches, embed_summary = embed_index_path(g)
            torch.cuda.empty_cache()
            log("phase 8d: RAGVT5Engine.inference with the XLM-R-base-width cross-encoder reranker, bf16")
            rerank_launches, rerank_summary = serve_reranked(g)
            torch.cuda.empty_cache()
        log("phase 8e: the BERT layer backward (K10) against its plain versions")
        bert_encoder_grad = check_bert_bwd(checks, g)
        torch.cuda.empty_cache()
        log("phase 8f: contrastive steps, bge-small, B 256 pairs, bf16 compute, f32 masters")
        contrastive_launches, contrastive_summary = contrastive_path(g)
        path_launches.update(embed_index=embed_launches, rerank_serve=rerank_launches,
                             contrastive=contrastive_launches)
        launches.update({k: embed_launches[k] for k in KERNELS if KERNELS[k][2] == "embed"})
        launches.update({k: contrastive_launches[k] for k in KERNELS if KERNELS[k][2] == "contrastive"})
        torch.cuda.empty_cache()
    if want("9"):
        with torch.inference_mode():
            log("phase 9a: the ViT layer (K14) and its parts against their plain versions")
            check_vit_kernels(checks, g)
            log("phase 9a: K2 and the K1 layer with the T5 bias at the visual branch's encoder length, T 709")
            check_visual_length(checks, g)
            log("phase 9b: full-width f32 ViT-base tower")
            check_vit_stack(g)
            torch.cuda.empty_cache()
            log(f"phase 9c: RAGVT5Engine.inference, concat, use_visual, t5-base + ViT-base, bf16; card and power "
                f"limit: {card}")
            visual_launches, visual_summary = serve_visual(g)
            torch.cuda.empty_cache()
            log("phase 9d: the query-tiled T5 layer (K13), K1 without a bias, MaxSim (K15), K3 at Te 709-2048")
            check_p2s_kernels(checks, g)
            log("phase 9e: full-width f32 pix2struct-base vision tower, T 128 and T 2048")
            check_p2s_stack(g)
        log(f"phase 9f: RAGPix2StructEngine, pix2struct-base, bf16, int8 cross cache; card and power limit: {card}")
        p2s_launches, p2s_indexed_launches, p2s_page_launches, p2s_summary = serve_p2s(g)
        path_launches.update(serve_visual=visual_launches, p2s=p2s_launches, p2s_indexed=p2s_indexed_launches,
                             p2s_page=p2s_page_launches)
        for path, counts in (("serve_visual", visual_launches), ("p2s", p2s_launches), ("p2s_page", p2s_page_launches)):
            launches.update({k: counts[k] for k in KERNELS if KERNELS[k][2] == path})
        torch.cuda.empty_cache()
    if want("10"):
        g10 = torch.Generator(device="cuda").manual_seed(SEED + 10)  # its own data: the other phases' stay
        with torch.inference_mode():
            log("phase 10a: Hi-VT5: the full-width f32 encode_document, then K1, K2, K3 and K14 at its shapes")
            hivt5 = {"encode_f32_max_abs_err": check_hivt5_encode(g10)}
            torch.cuda.empty_cache()
            check_hivt5_kernels(checks, g10)
            torch.cuda.empty_cache()
        log(f"phase 10b: HiVT5Engine.inference from build_engine, t5-base, B {HI_B} x {HI_P} page slots, bf16, int8 "
            f"cross cache, K3 on; card and power limit: {card}")
        hivt5_launches, hivt5["serve"], engine, served = serve_hivt5(g10, use_visual=False)
        log("phase 10e: attention_viz on the served batch")
        hivt5["attention_viz"] = hivt5_attention_viz(engine, served)
        del engine, served
        torch.cuda.empty_cache()
        log(f"phase 10c: the same with the per-page visual branch (ViT-base, 224 px renders from a seed); card and "
            f"power limit: {card}")
        hivt5_visual_launches, hivt5["visual_serve"], engine, _ = serve_hivt5(g10, use_visual=True)
        del engine
        torch.cuda.empty_cache()
        log(f"phase 10d: K6, K7 and K8 at B {HI_ROWS} T {HI_K + HI_T} against their plain versions; the full-width "
            "f32 forward_train gradient against the plain layer's")
        g13 = torch.Generator(device="cuda").manual_seed(SEED + 13)  # its own data: the train steps' stay
        check_hivt5_train_kernels(checks, g13)
        hivt5["train_grad_f32"] = check_hivt5_grad(g13)
        torch.cuda.empty_cache()
        log(f"phase 10d: make_hivt5_train_step, t5-base, B {HI_B} x {HI_P} page slots, bf16 compute, f32 masters")
        hivt5_train_launches, hivt5["train_step"] = train_hivt5(g10)
        torch.cuda.empty_cache()
        log("phase 10e: the train and eval entry points on configs/HiVT5_tiny.yml")
        hivt5["clis"] = hivt5_clis()
        path_launches.update(hivt5_serve=hivt5_launches, hivt5_visual_serve=hivt5_visual_launches,
                             hivt5_train=hivt5_train_launches)
        torch.cuda.empty_cache()
    if want("11"):
        g11 = torch.Generator(device="cuda").manual_seed(SEED + 11)  # its own data: the other phases' stay
        forms = {}
        log("phase 11a: K6, K7 and K8 gated and bias-free at pix2struct-base (B 8 x 1024 patches) and with the T5 bias "
            f"at T {VIS_T}; K2, K3 and K6 in f32 at d_kv 16")
        check_train_form_kernels(checks, g11)
        torch.cuda.empty_cache()
        log("phase 11b: full-width f32 gradients of Pix2Struct and VT5 (visual tokens, layout head) forward_train")
        forms["grad_f32"] = check_train_form_grads(g11)
        log(f"phase 11c: bf16 compute on f32 masters: VT5 with the layout head, VT5 at T {VIS_T}, Pix2Struct; card "
            f"and power limit: {card}")
        form_launches, forms["bf16"] = train_forms_bf16(g11)
        log(f"phase 11d: remat False, 'layer' and True on 10d's Hi-VT5 batch and 6d's VT5 batch; card and power "
            f"limit: {card}")
        remat_launches, forms["remat"] = remat_runs(g11)
        log(f"phase 11e: documents from local files, the eval entry point with ingest workers, MPIngestor; card and "
            f"power limit: {card}")
        file_launches, forms["local_files"] = local_files()
        log("phase 11f: the answer-quality cases on the card")
        quality_launches, forms["answer_quality"] = answer_quality()
        for counts in (form_launches, remat_launches, file_launches, quality_launches):
            path_launches.update(counts)
        torch.cuda.empty_cache()
    if want("12"):
        g12 = torch.Generator(device="cuda").manual_seed(SEED + 12)  # its own data: the other phases' stay
        layouts = {}
        log(f"phase 12a: the DiT layout detector at DiT-base width, B {DIT_B} pages, f32 (TF32 off); K14 at B {DIT_B} "
            f"T {VIT_T} in f32 and bf16; card and power limit: {card}")
        dit_launches, layouts["dit"] = check_dit(checks, g12)
        torch.cuda.empty_cache()
        log(f"phase 12b: YOLO at YOLOConfig() (width 32, 1024 px), B {YOLO_B} pages, f32, against the CPU; cuDNN TF32 "
            "on and off")
        yolo_launches, layouts["yolo"] = check_yolo(g12)
        torch.cuda.empty_cache()
        log(f"phase 12c: precompute layouts -> use_precomputed_layouts -> RAG-VT5 and RAG-Pix2Struct on an MP-DocVQA "
            f"directory of page images; card and power limit: {card}")
        e2e_launches, layouts["end_to_end"] = layouts_end_to_end(g12)
        torch.cuda.empty_cache()
        log("phase 12d: device_put_batch against to_device on phase 5's batch of 32; evaluate with each")
        transfer_launches, layouts["transfer"] = check_transfer(g12)
        torch.cuda.empty_cache()
        log("phase 12e: demo --serve on 127.0.0.1 and noise_experiment on the card")
        app_launches, layouts["apps"] = apps(g12)
        torch.cuda.empty_cache()
        log("phase 12f: K2, K6 and K3 in f32 at d_kv 16, timed beside SDPA")
        check_dkv16(checks, g12)
        path_launches.update(dit_detector=dit_launches, yolo_detector=yolo_launches, transfer_evaluate=transfer_launches,
                             **e2e_launches, **app_launches)
        torch.cuda.empty_cache()
    if want("13"):
        g13 = torch.Generator(device="cuda").manual_seed(SEED + 13)  # its own data: the other phases' stay
        causal = {}
        log("phase 13a: K2 causal GQA at the Qwen2.5-7B prefill shape, K2 at dh 256 (the Gemma reranker; bf16, f32, "
            "tile edges), K6 causal GQA at the LoRA shape, the causal LM's glue kernels at the Qwen2.5-VL-7B cell's "
            f"shapes, against their plain versions; card and power limit: {card}")
        check_causal_kernels(checks, g13)
        check_lm_glue(checks, g13)
        log("phase 13b: full-width f32 forward_hidden (7B widths 4 layers, Gemma-2b widths 2 layers) through K2 against "
            "the plain attention; the f32 LoRA gradient through K2/K6 against autograd through the plain attention")
        causal["stack_f32"] = check_causal_stack(g13)
        log(f"phase 13c: RAGQwenEngine.inference from build_engine at Qwen2.5-VL-7B's language-model widths, bf16, B "
            f"{QW_B} x {QW_DOCS_PAGES} pages; generate B 32; 13d: the visual path; card and power limit: {card}")
        qwen_launches, causal["qwen"], q7, q7_tok, q7_ingestor = serve_qwen(g13)
        launches.update({k: qwen_launches["qwen_serve"][k] for k in GLUE_KERNELS})
        log(f"phase 13f: LoRA SFT at the 7B widths, bf16 base, r 8 on q and v, B {LORA_B} x T {LORA_T}, 8 steps; card "
            f"and power limit: {card}")
        lora_launches, causal["lora_sft"] = lora_sft(g13, q7, q7_tok, q7_ingestor)
        del q7
        torch.cuda.empty_cache()
        log("phase 13c: generate B 8 on init_causal_lm_params_int8 weights at the 7B widths")
        causal["qwen"]["generate"]["int8_B8"] = generate_int8(g13)
        log(f"phase 13e: RAGVT5Engine.inference with the Gemma LLM reranker (build_reranker, bge-reranker-v2-gemma "
            f"widths), bf16, B 32; card and power limit: {card}")
        llm_rerank_launches, causal["llm_rerank_serve"] = serve_llm_reranked(g13)
        launches["flash_fwd_dh256"] = llm_rerank_launches["flash_fwd_dh256"]
        log("phase 13g: the train_lora and eval entry points on configs/Qwen_tiny.yml")
        causal["clis"] = qwen_clis()
        path_launches.update(lora_sft=lora_launches, llm_rerank_serve=llm_rerank_launches, **qwen_launches)
        torch.cuda.empty_cache()
    if want("14"):
        group_launches, multichip_summary = multichip(card)
        path_launches.update(group_launches)
        torch.cuda.empty_cache()
    if only:
        print(json.dumps({"ok": True, "phases": sorted(only), "card": card}), flush=True)
        return 0

    def times(unit: str, case: str) -> dict:
        row = checks.times[unit][case]
        return {k: row.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
                                        "library_device_ms")}

    report = {
        "kernels": [
            {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
             "max_abs_err": checks.err[name], **times(name, case), "case": case,
             "cases": checks.times[name],
             # phase 14: its launches in each group path, per rank of the dry run
             "group_launches": {path: n[name] for path, n in group_launches.items() if n.get(name, 0) > 0}}
            for name, (src, rep, _, case) in KERNELS.items()],
        # the whole layer K1 composes from rms_norm, gemm and flash_fwd
        "t5_layer": {"max_abs_err": checks.err["t5_layer"], **times("t5_layer", "B32 T512 t5-base bf16"),
                     "cases": checks.times["t5_layer"]},
        # K7 and K8 compose from gemm_bwd, rms_bwd and (K8) the K1 parts and K6
        "t5_ffn_bwd": {"max_abs_err": checks.err["t5_ffn_bwd"], **times("t5_ffn_bwd", "B8 T512 t5-base bf16"),
                       "cases": checks.times["t5_ffn_bwd"]},
        "t5_attn_bwd": {"max_abs_err": checks.err["t5_attn_bwd"], **times("t5_attn_bwd", "B8 T512 t5-base bf16"),
                        "cases": checks.times["t5_attn_bwd"]},
        "t5_layer_train": {"max_abs_err": checks.err["t5_layer_train"]},
        # phase 5b: the ten strategies' batches, the rows they encode, K3's splits at B 320, the eval CLI
        "strategies": strategies,
        "nac_train_step": nac_summary,
        "encoder_grad_max_rel_err": encoder_grad,
        "train_step": train_summary,
        "index": index_summary,
        # the whole layer K9 composes from bert_gemm, bert_layer_norm and flash_fwd, at both path shapes
        "bert_layer": {"max_abs_err": checks.err["bert_layer"], **times("bert_layer", "bge-small B1024 T64 bf16"),
                       "cases": checks.times["bert_layer"]},
        # K10's halves compose from bert_gemm_bwd, bert_ln_bwd, bert_col_sum, t5_gemm_bwd, the K9 parts and K6
        "bert_ffn_bwd": {"max_abs_err": checks.err["bert_ffn_bwd"], **times("bert_ffn_bwd", "bge-small B256 T64 bf16")},
        "bert_attn_bwd": {"max_abs_err": checks.err["bert_attn_bwd"], **times("bert_attn_bwd", "bge-small B256 T64 bf16")},
        "bert_layer_train": {"max_abs_err": checks.err["bert_layer_train"]},
        "bert_encoder_grad_max_rel_err": bert_encoder_grad,
        "embed_index": embed_summary,
        "rerank_serve": rerank_summary,
        "contrastive_step": contrastive_summary,
        # the whole layer K14 composes from vit_layer_norm, vit_gemm and vit_attention
        "vit_layer": {"max_abs_err": checks.err["vit_layer"], **times("vit_layer", f"beit B{VIT_B} T{VIT_T} ViT-base bf16"),
                      "cases": checks.times["vit_layer"]},
        # the two bias-free whole layers, composed from t5_rms_norm, t5_gemm and K2 without a bias: K1 without a
        # bias and K13, each against its own plain version; their parts' launches in the served batches and in
        # the 2048-patch batch
        "t5_layer_nobias": {"max_abs_err": checks.err["t5_layer_nobias"],
                            **times("t5_layer_nobias", "B136 T128 pix2struct-base bf16"),
                            "cases": checks.times["t5_layer_nobias"],
                            "parts_launched": {k: p2s_launches[k] for k in TOWER_KERNELS}},
        "t5_layer_qtiled": {"max_abs_err": checks.err["t5_layer_qtiled"],
                            **times("t5_layer_qtiled", "B8 T2048 pix2struct-base bf16"),
                            "cases": checks.times["t5_layer_qtiled"],
                            "parts_launched": {k: p2s_page_launches[k] for k in TOWER_KERNELS}},
        "visual_serve": visual_summary,
        "p2s_serve": p2s_summary,
        # phase 10: Hi-VT5 served with and without the per-page visual branch, trained, its attention maps, its CLIs
        "hivt5": hivt5,
        # phase 11: the VT5 family's training forms, remat, documents from local files, answer quality
        "train_forms": forms,
        # phase 12: the layout detectors, precompute layouts through layout-guided serving, the transfer, the apps
        "layouts": layouts,
        # phase 13: the causal-LM family: f32 stacks and the LoRA gradient, Qwen2.5-VL-7B serving, the visual path,
        # generate (bf16, int8), LoRA SFT, the Gemma LLM reranker, the CLIs
        "causal_lm": causal,
        # phase 14: the group paths (world-size-1 NCCL group) against their unsharded forms, the two-rank dry run
        "multichip": multichip_summary,
        # every kernel's launches in each path's run, counts set to 0 just before it
        "launches_by_path": path_launches,
        "card": card,
    }
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
