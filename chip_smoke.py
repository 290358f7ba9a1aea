#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit:

1. build   — compile every CUDA kernel of the path from paddle_tpu_torch/csrc
             (one nvcc per source, all started together); fail if ptxas
             serialised the wgmma products of any wgmma kernel (flash
             forward, backward and dbias, fused CE forward and backward).
2. check   — hold each kernel against its plain PyTorch version on the card,
             at the shapes GPT-2 345M gives it and at tail shapes; the bf16
             flash forward and backward also by a relative measure beside
             its rounding control and the faults flash_fwd_faults and
             flash_bwd_faults plant, two calls bitwise equal, at their tile
             edges (sequences ending inside a 128 tile, sq > sk, sq < sk,
             D = 128) and past B*H = 65,535; the masked flash kernels at
             BERT-base's layer with its padding bias (past B*H = 65,535
             too), in every bias class, with segment ids and with rows that
             see no key; the dbias kernel (two calls bitwise equal, splits
             whose last run is short) beside the faults dbias_faults
             plants; the fused CE forward (two calls bitwise equal, token
             and vocabulary tails) beside the faults ce_fwd_faults plants;
             the fused CE backward in vocabulary chunks (two calls bitwise
             equal) beside the faults ce_bwd_faults plants; a small GPT on
             the card against the same model on the CPU:
             forward, loss, gradients, one f32 TrainStep, and three f32
             TrainSteps of the fused configuration; a small BERT on a padded
             batch (logits, loss, gradients, one AdamW step) and a small
             learned-bias encoder (gradients, the bias's included), card
             against CPU; bench.py's small ResNet (resnet18, B=8, 64x64),
             card against CPU: an f32 training forward's loss, logits and
             every running stat beside two planted batch-norm faults
             (PyTorch's momentum convention, the biased variance), every
             gradient and one Momentum step's moves in f64 and eval mode,
             and the port's f32 convolution (TF32 switched on around it,
             cuDNN's TF32 read beside it) and batch norm alone; #8's bf16
             instantiation at GPT-2 345M's 16 stacked tensors (354,871,296
             values) bitwise its plain version, two calls bitwise equal,
             beside three planted faults (a truncating store, the step
             taken from the rounded m' and v', the rate formed from f32
             beta pows), then bitwise at tails (lengths no multiple of 8,
             40 tensors); a start off a 16-byte boundary is refused.
3. serve   — GPT-2 345M (remat=False in phases 3-5 and 10, as bench.py's
             GPT-2 legs run it) at full width and depth in bf16 answers a
             batch of B=8 prompts of S=1024 tokens: logits and next-token argmax, then
             gpt_loss scoring with the fused-CE flag off and on.  The launch
             counters are set to 0 just before and read just after.
4. train   — GPT-2 345M at full width and depth, f32 masters, trains as
             bench.py configures it: TrainStep with AMP O2 bf16 and
             AdamW(learning_rate=1e-4), 5 steps on one B=8, S=1024 batch.
             Counters set to 0 just before, read after every step.
5. train-fused — the same model on the fused path, as a memory-bound user
             trains it: fused CE head, AdamW(use_fused=True) with decay
             0.01, a global-norm clip at 1.0 and a warmup-then-cosine rate,
             accumulate_steps=2 over a global batch of 16 x 1024, AMP O2
             bf16, 5 steps.  First the fused Adam kernel is held to its
             plain version on the model's own parameter set and timed.
             Counters set to 0 just before the steps, read after each.
6. remat   — a small f32 GPT and a small f32 BERT (padded) on the card:
             loss and gradients with per-layer remat, with the whole loss
             recomputed and with both bitwise those without, and within
             1e-4 of the CPU; then the train phase's GPT-2 345M step in four
             forms from the same parameters (remat=False, remat=True,
             TrainStep(recompute=True), both): step ms, peak bytes, the bf16
             losses and final parameters bitwise equal across the forms
             and remat=False's losses bitwise the train phase's, 1 + remat
             + recompute flash forward launches a layer a step; beside each
             form the host's side of a step (until step() returns, process
             CPU, allocator calls, the Python collector) and the host time
             of its replays in one more step traced on the host.
7. bert-serve — BERT-base (12 layers, H=768, V=30522) in bf16 answers 3
             requests of B=128 x S=128 on a padded batch under
             inference_mode: MLM and NSP logits, 12 masked forward launches
             a request and nothing else.
8. bert-train — BERT-base, f32 masters, as bench.py:204-250 trains it
             (remat=True): TrainStep with AMP O2 bf16,
             AdamW(learning_rate=1e-4), bert_pretrain_loss, B=128, S=128,
             15 % MLM labels; 5 steps unpadded, then 5 on the padded batch
             (24 forward, 12 dq and 12 dk/dv launches a step, masked on the
             padded one, no dbias); then the same with remat=False (12
             forward launches), whose losses must be bitwise the same.  An
             all-ones mask must give the unmasked loss.
9. encoder-bias — a 12-layer TransformerEncoder (768, 12 heads, 3072,
             GELU) that trains a learned (1, 12, 128, 128) attention bias
             as its src_mask: 5 O2 AdamW steps on a mean-square loss at
             B=128, S=128, 12 launches of each masked kernel and of dbias
             a step.  Counters set to 0 just before each of phases 6-9.
10. zero   — the row quantizer #9 bitwise against its plain codec over a
             boundary corpus (widths 1 to 1024, 1 to 100k rows, ties, zero
             and NaN/inf rows) and on GPT-2 345M's gradient in 256-wide
             rows; then bench.py's bench_gpt2_zero step, GPT-2 345M at full
             width and depth, B=8, S=1024, O2 bf16, AdamW(1e-4), through
             ShardedUpdateTrainStep at world size 1 over NCCL: TrainStep
             against itself, then the f32 wire (bitwise TrainStep), bf16,
             int8 and int4 (32 #9 launches a step) and the int4 ring (none:
             dp = 1 returns before encoding; bitwise the f32 wire), and the
             int8 step through the plain codec (bitwise the kernel's); then
             the int8 / int4 ring primitives at dp = 2 and 4 (ranks as
             threads, a 1024 x 4096 leaf a rank) bitwise the same ring on
             the CPU and within the codec's envelope of the exact sum, a
             mis-seated hop planted outside it; then dp = 2 simulated as two
             threads at GPT-2 345M's width and 2 layers: f32 ZeRO bitwise
             the replicated step, int8 and the int4 ring with exact per-rank
             #9 counts, bitwise the same steps through the plain codec,
             replicas bitwise equal after every step, losses within
             TOL_ZERO_LOSS of the f32 run and planted faults (parameters
             left unchanged, a mis-seated hop, a wrong qmax) read beside it.
             Counters set to 0 before each run.
11. longseq — bench.py's bench_longseq_flash: first the flash forward
             and backward at its layer (B*H=8, S=2048 and 8192, D=128,
             causal, bf16) against their plain versions, beside planted
             faults, and timed beside SDPA at S=8192; then gpt_tiny(4
             layers, H=1024, 8 heads, V=8192, remat=True), TrainStep(O2
             bf16), AdamW(1e-4), B=1: S=2048 for
             6 timed steps and S=8192 for 3, each after 2 warm-ups;
             tokens/s at both lengths and their ratio, 8 forward, 4 dq and
             4 dk/dv launches a step, the first loss near ln V.
12. masked-flash — bench.py's bench_masked_flash: B=4, S=2048, 16 heads
             of 64, bf16, a (B, 1, 1, S) padding bias from its lengths; the
             masked kernels against their plain versions, then fwd+bwd
             through flash_attention masked and unmasked (one launch of
             each kernel), their times and the retention, and each
             kernel's time beside SDPA's.
13. resnet50-train — bench.py's bench_resnet50: resnet50(num_classes=1000),
             NCHW, f32 masters, TrainStep with AMP O2 bf16, Momentum(0.1,
             0.9), B=128 at 224x224 from default_rng(0), one warm-up then 5
             steps: step ms, samples/s, peak bytes; losses finite, every
             running stat finite and moved, every parameter moved.
14. resnet50-eval — the same model's eval() forward under the O2 cast:
             samples/s; finite logits that differ from the training-mode
             forward's on the same batch.
15. lenet-train — bench.py's bench_lenet: LeNet, f32, Adam(1e-3), B=256,
             2 warm-ups then 50 steps: samples/s; the last loss below the
             first.  Phases 13-15 print the card's name and power limit
             beside their numbers; no hand-written kernel is on their path.
16. seq2seq-small — the seq2seq composition (source and target
             Embeddings, learned positions, the Transformer, a Linear head)
             at 2 + 2 layers, d_model 128, 2 heads of 64, V=512, S=256 ->
             128, f32, card against CPU: logits, the label-smoothed loss,
             every gradient, one Adam step; 20 steps of one batch whose
             loss must fall; a beam decode whose invariants hold.
17. seq2seq-train — #1-#3 first against their plain versions beside the
             planted faults at the path's three mask shapes (cross-attention
             128 queries over 256 keys under the source's bias row, the
             decoder's full (1, 1, 128, 128) causal bias, the encoder at
             S=256), then Transformer-base (6 + 6 layers, d_model 512, 8
             heads, FFN 2048, V=30000 + 30000) trained as the translation
             recipe trains it: TrainStep with AMP O2 bf16, Adam(beta2 0.98,
             epsilon 1e-9) under NoamDecay(512, 4000, 2.0), dropout 0.1,
             label smoothing 0.1, B=32 sources of 256 and targets of 128
             ids, 2 warm-ups and 8 timed steps: step ms, target tokens/s,
             peak bytes, 18 launches of each masked kernel a step and no
             other, the first loss near ln V, every parameter moved.
18. seq2seq-serve — the trained model in bf16, eval mode: 4 requests of 8
             sources of 256 ids, the encoder once (6 masked forward
             launches) and beam search (beam 4, at most 128 steps) through
             BeamSearchDecoder + dynamic_decode over the decoder's caches
             (no kernel launch: one query row takes the dense path);
             latency, generated tokens/s, log-probs falling across the
             beams, the best beam's log-prob equal to its teacher-forced
             rescoring, gather_tree's sequences following the parents.
19. rnn — LSTM and GRU (2 layers, bidirect, hidden 512, input 512),
             B=128, T=50 with sequence lengths, f32, card against CPU
             (outputs, states, every gradient); forward + backward ms.
             Counters set to 0 just before each of phases 17 and 18's
             runs.
20. eager-small — the dygraph loop (loss.backward(); opt.step();
             opt.clear_grad()) of each of the ten optimizers on a small MLP
             whose parameters carry ParamAttrs (a rate scale, L1 and L2
             regularisers, a frozen bias), f32, card against CPU, and
             state_dict -> set_state_dict resuming bitwise; a small GPT and
             MobileNetV2 (scale 0.25, 64x64) under auto_cast O1 and O2
             (GPT's O2 after decorate): each op's input dtypes, one
             GradScaler step.
21. eager-gpt — GPT-2 345M at full width and depth, B=8, S=1024, trained
             by the dygraph loop: decorate O2, auto_cast O2, GradScaler(),
             AdamW(1e-4, use_fused=True) (#8 in bf16, one launch a step),
             2 warm-ups and 8 timed steps: tokens/s, peak bytes, the
             device's idle share and the host ms until a step returns,
             beside the train phase's TrainStep; #1-#3 24 launches each a
             step.  As in the reference, beta2 = 0.999 rounds to 1.0 in
             bf16, lr_t is 0 and no parameter moves: the check holds the
             parameters bitwise, the loss repeating, the moments moving;
             then 3 steps at beta2 = 0.99, where the loss must fall and the
             parameters move.
22. eager-vision — MobileNetV2 (1.0, 1000 classes), B=96 at 224x224, under
             auto_cast O1 with RMSProp(0.045, rho 0.9, momentum 0.9) and
             L2Decay(4e-5) (Sandler et al. 2018, §6.1): convolution inputs
             bf16, batch-norm inputs f32, finite losses, samples/s, peak
             bytes, idle share; then one step at 224x224, B=2, card
             against CPU in f64 and evaluation mode (f32 ReLU and max-pool
             kinks flip between devices; training-mode batch norms keep
             f32 statistics): Momentum for VGG-16 and MobileNetV1, the
             recipe above for MobileNetV2 (GradScaler().minimize, without
             auto_cast); MobileNetV2's O1 loss, card against CPU.
             Counters set to 0 just before each of phases 21 and 22's
             runs.
23. timing — each kernel, its plain version, the one-call PyTorch yardstick
             and the least time the card could take for the same work; the
             masked kernels and dbias at BERT-base's layer, #1-#3 at the
             seq2seq path's three mask shapes beside SDPA (and the decoder's
             self-attention through the unmasked causal kernel), the flash
             kernel against the dense path there; the fused CE backward's
             three passes (profiler device time) beside the pair's time;
             #8 in f32 and in bf16 (beside torch.optim.AdamW(fused=True)
             over bf16 parameters); #9 on GPT-2 345M's gradient; tokens/s
             of the forward.
24. transforms-resnet50 — bench.py's file-fed ResNet-50 recipe without its
             ingest plane: 512 uint8 images of 256x256x3 from
             default_rng(0) through vision.transforms' Compose([
             RandomResizedCrop(224), RandomHorizontalFlip()]) drawing from
             random.Random(0), on the host batch by batch (the resize route,
             PIL or numpy, logged), collated as _filefed_collate (/255,
             ImageNet mean and std, NCHW), moved to the card and fed to the
             resnet50-train phase's TrainStep (O2 bf16, Momentum(0.1, 0.9))
             at B=128: one warm-up, then 3 steps.  Host ms a batch of the
             transforms, the collate and the copy, step ms, the input's
             share of the loop's wall; finite losses, every parameter moved,
             the first batch's transforms bitwise equal when run again
             from the seed.
25. dcgan — DCGAN (Radford et al., arXiv:1511.06434) of the port's
             public layers (Conv2DTranspose, Conv2D, BatchNorm2D, ReLU,
             LeakyReLU, Tanh, BCEWithLogitsLoss; N(0, 0.02) weights by
             ParamAttr), trained by the eager loop with Adam(2e-4,
             beta1=0.5) for each network, a D step on real and fake then a
             G step: at ngf = ndf = 16, B=8 card against CPU, in IEEE f32
             each convolution alone (output and gradients) and a
             training-mode forward (both losses, every running stat), then
             in f64 and evaluation mode one iteration (both losses, every
             gradient, one step of each optimizer from the CPU's
             gradients); then at ngf = ndf = 128, B=128, 64x64,
             f32: 2 warm-ups and 10 timed iterations, ms an iteration,
             images/s, peak bytes, finite losses, every parameter of both
             networks moved.
26. nn-breadth — the new functionals on the card against the CPU in f32
             at shapes their users run, each with its forward + backward ms:
             max_pool2d(3, 2, 1, return_mask=True) -> max_unpool2d on
             ResNet's stem output (32, 64, 112, 112) ReLU'd (mask and pooled
             values bitwise, the tie-splitting gradient), interpolate
             bilinear x2 up and down and bicubic x2 up at (8, 256, 64, 64),
             ctc_loss at DeepSpeech2's 29 classes (B=32, T=400, labels up to
             100), grid_sample at (8, 64, 56, 56), linear_chain_crf and
             viterbi_decode at a BiLSTM-CRF's B=64, T=50, 9 tags (paths
             bitwise), unfold / fold at (8, 64, 56, 56) k3 and pixel_shuffle
             at (8, 256, 56, 56).  No hand-written kernel lies on phases
             24-26; they print the card's name and power limit beside their
             numbers.
27. resnet50-gn — Wu and He's ResNet-50 with GroupNorm(32, C) in place of
             every BatchNorm2D (swapped after construction through the
             Layer API: named_sublayers, then setattr on the parent), first
             resnet18-GN at B=8, 64x64 card against CPU (a training-mode
             f32 forward's loss and logits beside a planted 16-group fault,
             and group_norm alone forward and backward, TOL_VISION_F32);
             then trained as resnet50-train: TrainStep O2 bf16, Momentum(
             0.1, 0.9), B=128 at 224x224, one warm-up then 5 steps: step ms
             beside resnet50-train's, samples/s, peak bytes, the device's
             busy ms and idle share of one traced step; finite losses,
             every parameter moved.
28. sn-dcgan — phase 25's DCGAN with nn.utils.spectral_norm on each of
             D's five convolutions (SN-GAN, Miyato et al. 2018): the small
             model card against CPU at phase 25's limits (the spectral
             vectors take no gradient on either and do not move), then the
             published widths at B=128: ms an iteration beside dcgan's,
             images/s, peak bytes.
29. sparse-embedding — a (50304, 1024) f32 Embedding(sparse=True) fed one
             GPT-2 batch of 8 x 1024 ids a step, trained eagerly by SGD and
             by Adam(lazy_mode=True), each beside the same table with
             sparse=False: ms a step and the host's ms until a step
             returns, the merged rows, the sparse table within 1e-6 of the
             dense one; first a 1000 x 64 table (padding_idx, repeated ids)
             card against CPU within 1e-6, table and states.
30. norm-breadth and rnn-amp — instance_norm, group_norm (NCHW, NHWC),
             local_response_norm, normalize and a weight_norm'd 1x1
             Conv2D(256, 64) at ResNet-50 stage 2's activation (128, 256,
             56, 56), f32 and bf16, forward and backward card against CPU
             (f32 values within TOL_BREADTH and gradients TOL_F32, bf16 by
             scaled_err within TOL_BF16 and TOL_GRAD_BF16) beside a planted
             fault in each dtype; then phase 19's LSTM and GRU and an RNN
             over one LSTMCell under auto_cast O2 and under O1 with
             custom_white_list={"lstm_cell"}: each op's input dtypes
             (required), card against CPU, forward + backward ms.  No
             hand-written kernel lies on phases 27-30.
31. yolov3-dcn train — PaddleDetection's yolov3_r50vd_dcn_270e_coco
             composed of the port's pieces (yolov3_dcn): resnet50 (not the
             vd variant) whose layer4.{0,1,2}.conv2 are swapped through
             named_sublayers for DCNv2 (a zero-initialised 3x3 convolution
             making 18 offsets and 9 sigmoid masks, and vision.ops'
             DeformConv2D with the block's stride), the YOLOv3 FPN
             (detection blocks of 512, 256 and 128 channels, 1x1 routes, x2
             nearest upsampling, concatenation, 255-channel heads) and
             yolo_loss at 19x19, 38x38 and 76x76 (COCO's anchors and masks,
             ignore_thresh 0.7, no label smoothing).  First the same
             composition at resnet18, 128x128, B=2, 4 classes card against
             CPU: a training-mode f32 loss, then in f64 evaluation mode the
             loss, every gradient and one Momentum step's moves, beside a
             planted fault (offsets read as (dx, dy)) that must exceed the
             limit.  Then at full width, f32, B=8 at 608x608 with 50 gt rows
             an image (20 boxes), Momentum(1e-3, 0.9) + L2Decay(5e-4), the
             eager loop: one warm-up and 5 steps, ms a step, images/s, peak
             bytes, the idle share of one traced step, finite losses; then
             deform_conv2d beside Conv2D at layer4.1.conv2's shape (zero
             offsets, masks of 1: equal within TOL_F32), forward + backward.
32. yolov3-dcn serve — the trained composition in evaluation mode, B=8 at
             608x608, then yolo_box at each head (conf_thresh 0.005): ms a
             batch, images/s, finite boxes and scores of the expected
             shapes; the small composition's eval-mode decode held to the
             CPU within TOL_F32 (boxes and scores).  Then multiclass_nms at
             PaddleDetection's YOLOv3 settings (YOLO_NMS) over the three
             heads' (8, 22743, 4) boxes and (8, 80, 22743) scores: ms beside
             the forward's, peak bytes, detections an image (at most 100,
             finite, each class's kept boxes pairwise at most 0.45 IoU), how
             many the planted one-pass NMS fault (one_pass_keep) changes;
             matrix_nms linear and Gaussian (YOLO_MATRIX), ms; the small
             composition's multiclass_nms and matrix_nms on the card bitwise
             the CPU's on the CPU's yolo_box output, and a chain (A over B
             over C, A clear of C) that greedy NMS keeps whole and the
             fault cuts.
33. det-ops — roi_align at 7 and 14, aligned and not, and roi_pool at 7 on
             Mask R-CNN R50-FPN's P2 map (2, 256, 200, 336) f32 with 512
             RoIs an image (16-160 pixel boxes), spatial_scale 0.25: card
             against CPU on 64 RoIs (values within TOL_BREADTH, gradients
             within TOL_F32) beside a planted fault (aligned flipped; the far
             corner floored), forward + backward ms over every RoI, and the
             peak bytes each needs, roi_pool's beside the reference's
             (R, oh, C, H, W) masked max; then yolo_box, box_coder,
             prior_box and density_prior_box at SSD300's 38x38 map card
             against CPU (the priors bitwise), ms each.  No hand-written
             kernel lies on phases 31-33.
34. faster-rcnn train — PaddleDetection's faster_rcnn_r50_fpn_1x_coco
             composed of the port's pieces (faster_rcnn_fpn, FRCNN_FULL):
             resnet50's C2-C5, an FPN of 256 with P6, the RPN head, anchors
             32-512 (268,569 an image), rpn_target_assign, generate_proposals
             at every level, collect_fpn_proposals, generate_proposal_labels
             (512 RoIs an image, 81 classes), distribute_fpn_proposals,
             roi_align 7x7 at P2-P5, two FC of 1024, the RPN's and the RoI
             head's losses.  First the same composition at resnet18, P4-P5,
             128x128, B=2, 4 classes card against CPU (check_small_frcnn):
             f64 in evaluation mode, the RPN and RoI samples bitwise, the
             loss, every gradient and one Momentum step's moves within
             TOL_F32, the chain through generate_proposals beside the
             planted fault, the f32 serve's multiclass_nms bitwise on the
             CPU's decoded boxes.  Then B=2 at 800x1344, f32, Momentum(0.01,
             0.9) + L2Decay(1e-4), one warm-up and 5 eager steps: ms a
             step, images/s, peak bytes, the idle share of one traced step,
             then one step with its stages synchronized: host ms of the
             target stages and of the proposal stages, fg / bg counts of
             each stage; every loss finite.
35. faster-rcnn serve — the trained composition in evaluation mode, B=2 at
             800x1344: proposals 1000 / 1000 a level, 1000 collected an
             image, the RoI head, softmax, box_decoder_and_assign, box_clip
             and multiclass_nms (background 0, 0.05, NMS 0.5, 100 kept) per
             image: ms a batch, images/s, the proposal stage's and the NMS's
             ms; the detections within NMS's invariants.
36. det-tail — the rest of vision.ops' second half card against CPU on
             identical inputs (indices, labels, kept sets bitwise; values and
             gradients within TOL_F32), each timed at its model's shape:
             SSD300's target stage (bipartite_match, target_assign,
             mine_hard_examples), RetinaNet R50-FPN's retinanet_target_assign
             and retinanet_detection_output (bitwise on zero deltas, whose
             decode is exact; its invariants on random ones), Mask R-CNN's
             generate_mask_labels over phase 34's samples,
             locality_aware_nms on EAST's 128x128 map,
             roi_perspective_transform at FOTS's RoIRotate (PERSP) and
             box_decoder_and_assign at Faster R-CNN serve's 2,000 RoIs,
             forward and backward.  No hand-written kernel lies on phases
             34-36.
37. gpt-eval — phase 3's GPT-2 345M (bf16, the same seed and B=8 x 1024
             batch) evaluated through paddle_tpu_torch.tensor on the f32
             logits of its unfused head (8,184 x 50,304, as gpt_loss forms
             them): next-token NLL (logsumexp minus index_sample), its mean
             against gpt_loss's and perplexity; accuracy at k=1 and 5,
             argmax agreement; topk(40); the nucleus cut at p = 0.9
             (argsort descending, softmax, cumsum, searchsorted row by row);
             quantile 0.5 / 0.9 / 0.99 and median over the model's
             354,871,296 parameter magnitudes, each against the sorted
             values it interpolates between.  The same calls on a CPU copy
             of 64 rows (of 2**20 parameter values): indices bitwise (the
             bf16 logits are full of ties), values within TOL_F32; the naive
             torch.topk (on the CPU copy), torch.argsort(descending=True,
             stable=True) and torch.median are run beside and must be told
             apart; the rows where the card's torch.topk orders ties
             otherwise than lax.top_k are counted.  Each call
             group's ms at the full shape after a warm-up, the peak bytes
             and the wall seconds.
38. tensor-probe — a ridge probe from phase 37's final hidden states
             (X: 8,184 x 1,024, f32) to the next token's embedding (wte[y]):
             A = X^T X / N + lambda I, solved by cholesky + cholesky_solve
             (and + two triangular_solves), solve, inverse, lstsq (of X
             stacked on sqrt(lambda) I) and pinv,
             the solutions held to one another and to their residuals;
             svd, eigh / eigvalsh, qr, lu (0-based pivots, beside
             torch.linalg.lu_factor's 1-based ones), slogdet, cond,
             matrix_rank, cov / corrcoef, the norms and multi_dot by their
             invariants; det and matrix_power on a 64 x 64 block; the probe
             again on 64 rows, card against CPU.  Then every other name of
             the tensor library once (breadth) on GPT-2's activation
             (8 x 1,024 x 1,024) in f32 and bf16 and on the token ids, card
             against a CPU copy of 64 rows (TOL_F32 / TOL_BF16 by the
             scaled measure, integers and linspace bitwise), beside the
             naive torch.linspace, torch.hypot at 1e20, torch.digamma(0)
             and an int32 + 1.5 in float32, which must be told apart.  No
             hand-written kernel lies on phases 37-38.
39. gpt-checkpoint — eager-gpt's loop (GPT-2 345M, B=8, S=1024, decorate
             O2, GradScaler, auto_cast O2, AdamW(use_fused=True), #8 in
             bf16) at beta2 = 0.99 under CosineAnnealingDecay(1e-4): two
             steps, then save(model.state_dict()) and save(opt.state_dict())
             into a temporary directory, a fresh pair load +
             set_state_dict, and one more step on both: every loaded
             tensor bitwise the saved one with its dtype (bf16 parameters
             and moments, beta pows, @global_step, the scheduler), through
             the files and through dumps / loads, beside a planted state
             dict missing one moment; the resumed step's loss, parameters
             and moments bitwise the original's, or within 4x the spread
             of the original repeating its step from memory.  File bytes,
             seconds to save and to load.
40. gpt-sample — phase 3's GPT-2 345M (bf16): from an 8 x 992 prompt, 32
             tokens a row by full re-forward under no_grad, each step
             topk(40), the nucleus at 0.9 (softmax, cumsum, a mask),
             multinomial and concat: the same seed bitwise the same
             tokens, another seed others, every token within its step's
             kept set recomputed by torch.sort (beside the planted sampler
             that ignores the nucleus), set_rng_state(get_rng_state())
             replaying a step; ms a step, generated tokens/s, 24 #1
             launches a forward.
41. bert-ragged and breadth — BERT-base (bf16) over 128 sentences of
             8-128 tokens in the flat encoding: lengths_to_segment_ids,
             sequence_pad to 128 x 128, the masked forward (12 launches of
             masked #1), sequence_unpad, every sequence_pool type,
             first / last step, segment_softmax attention pooling,
             embedding_bag over the 30,522 x 768 word table (sum, mean,
             max, padding_idx 0), one backward of a pooled loss (12 masked
             dq and dk/dv, 12 forwards replayed by remat), sequence_reverse
             / concat / enumerate / expand_as / mask: card against a CPU
             copy of the same inputs, unpad(pad(x)) bitwise, the mean bag
             equal to the pooled lookup, beside planted torch.max(dim) tie
             gradients, scatter_reduce's include_self on an empty segment,
             a first-wins scatter and torch.multinomial refusing a row of
             zeros.  Then every manipulation name once at GPT-2's
             activation (8 x 1,024 x 1,024, f32 and bf16; each gather and
             scatter given indices past its axis and negative ones),
             card against a 64-row CPU copy; every sampler on 10^7 draws
             (mean and variance within 6 sigma, randperm a permutation,
             multinomial distinct); grad(create_graph=True) twice and the
             top-level aliases, card against CPU; one more launch and a
             synchronize so no device-side assert hides.  The launch
             counters are set to 0 before each of phases 39-41 and their
             launches join the kernel table's.
42. int8-resnet18 — bench.py's bench_int8_resnet18 leg: ResNet-18 with
             1,000 classes, B=128 at 224^2, eval; jit.to_static of the f32
             net against eager, and of a copy through
             quantization.convert_to_int8_inference; top-1 agreement of
             int8 with f32 >= 0.7 before any timing; the stem's and the
             fc's int32 accumulators bitwise the CPU's on 4 images, the
             fc's epilogue within 1e-6, beside a flipped stem code and fc
             scales 1 % off; images/s of f32 and int8 and their ratio.
43. gpt-deploy — phase 3's GPT-2 345M (bf16): to_static logits at
             B=8, S=1024 against eager (one capture a signature, B=4 a
             second; 24 #1 launches from the graph); gpt_loss captured,
             forward and backward, with FLAGS_gpt_fused_ce off and on
             (24 #1, #2, #3 and 0 or 1 #5, #6, #7 launches from the
             graph), gradients against eager; jit.save with
             InputSpec([None, 1024], "int64"), then
             inference.create_predictor on the card run at B=8 and B=2
             (24 #1 launches a run), logits against eager, beside one
             weight of the artifact 5 % off; the export, save and load
             seconds and the file bytes.
44. capture-breadth — tests/test_dy2static.py's tensor if, while and
             for-range and every static.nn function captured on the card
             against the CPU; a 2-layer learned-bias encoder at BERT-base's
             width captured, forward and backward (2 launches each of
             masked #1-#3 and #4 from the graph), its gradients and dbias
             against eager; an encrypted jit.save through the Predictor
             bitwise, a missing key, a wrong key and a tampered byte
             raising; an artifact captured on the CPU loaded on the card
             (moved by the load) against the CPU; the host cipher's MB/s;
             unique of NaNs and the
             top-level namespace on the card.  The launches of phases
             43-44 join the kernel table's and are its captured_launches.
45. fleet-gpt — GPT-2 345M (24 layers, B=8, S=1024, remat=False, O2 bf16,
             AdamW(1e-4)) through fleet.init(is_collective=True),
             fleet.distributed_optimizer and fleet.train_step at world size
             1 over NCCL: plain dp and sharding stages 1, 2 and 3, each run
             bitwise the train phase's TrainStep losses and parameters, 24
             launches each of #1-#3 a step; step ms, tokens/s, peak bytes,
             optimizer-state bytes a replica.  Then dp = 2 simulated
             (LoopbackWorld, GPT-2's width, ZERO_DP2_LAYERS layers, the
             global 8 x 1024, f32, SGD): stages 0-3 bitwise one another
             and within TOL_DP2_LOSS / TOL_DP2_MOVE of one-rank TrainStep
             on the global batch, beside the planted summed gradients.
46. dp-meta — the same 2-layer model at simulated dp = 2: LocalSGD (k = 2,
             begin_step = 3) whose replicas differ between syncs and are
             bitwise equal after one; DGC (SGD, sparsity 0.999 after one
             dense step): k x dp entries exchanged a tensor, the dense
             result bitwise the reconstruction from both ranks' (values,
             indices), the exchanged u and v zeroed, beside the planted DGC
             that keeps v; losses finite and falling.
47. syncbn — ResNet-50 converted by convert_sync_batchnorm under
             ShardedTrainStep at simulated dp = 2 (2 x 32 at 224^2)
             against BatchNorm over the global 64 on one rank: the f32
             training forward's loss, logits and every running stat,
             beside rank-local statistics; resnet18 (2 x 4, 64^2) in f64
             training mode, every gradient; the same ResNet-50 under
             LocalSGD keeps each rank's statistics until a sync, beside the
             planted sync that skips the buffers.  The launch counters are
             set to 0 before each of phases 45-46 and their launches join
             the kernel table's.

48. tp-gpt — GPT-2 345M's width at 8 layers (B=8, S=1024, remat=False;
             the depth cut from 24, each rank's path the same) at mp = 2
             on two LoopbackWorld ranks (threads on the one card: every
             time is the simulation's, NCCL at two or more ranks is
             unmeasured): bf16 serving, the gathered logits and the loss
             against mp = 1, beside a planted qkv shard cut contiguously
             instead of by head; 3 ShardedTrainStep steps (O2 bf16,
             AdamW(1e-4)) against a one-rank TrainStep's losses and
             parameters (that run twice, bitwise), both ranks' gathered
             parameters bitwise equal, each rank's parameter bytes, the
             host hop's bytes, step ms, peak bytes, 8 launches of #1-#3 a
             rank a
             step; dp x mp x sp = 2 x 2 x 2 (8 threads, 2 layers, f32,
             SGD) against one-rank TrainStep on the global batch; fleet
             with hybrid_configs {"mp_degree": 2} builds that step.
49. sp-ring — ring attention on bench_longseq_flash's layer (B*H = 8,
             S = 8192, D = 128, causal, bf16) at sp = 2 and 4 against
             #1-#3 on the whole sequence, r + 1 launches of each on rank
             r, beside three planted faults (every chunk causal, a merge
             without the chunks' lse, delta from a chunk's output); phase
             48's model at sp = 2 served against sp = 1 and trained 3 steps
             against one-rank TrainStep.  The launches of phases
             48-49 join the kernel table's and are its tp_sp_launches.
50. pp-gpt — phase 48's model at pp = 2 (4 layers a stage on two
             LoopbackWorld threads, 4 microbatches of 2 rows) in both
             schedules (F-then-B, 1F1B): f32 and bf16 serving against
             pp = 1; one f32 SGD step and 3 O2 bf16 AdamW(1e-4) steps
             against one-rank TrainStep, 16 launches each of #1-#3 a rank
             a step, the live microbatch graphs by stage (4 under
             F-then-B, 2 and 1 under 1F1B), peak bytes by schedule, beside
             three planted faults (the boundary's input gradient not sent
             back, the last stage's labels a microbatch off, wte's
             gradient summed over the stages); pp = 4 in 1F1B; dp x pp x
             mp = 2 x 2 x 2 and pp x sp = 2 x 2 at 2 layers (f32, SGD)
             against one-rank TrainStep.  Its launches join the kernel
             table's and are its pp_launches.
51. bert-mp — BERT-base (12 layers, B=128, S=128, remat=False) at mp = 2
             on two LoopbackWorld threads, 6 heads a rank, unpadded and
             padded: bf16 serving, the gathered MLM logits and the loss
             against mp = 1, beside the qkv shard cut contiguously; 3
             ShardedTrainStep steps (O2 bf16, AdamW(1e-4)) against
             one-rank TrainStep, both ranks' gathered parameters bitwise
             equal, beside copy_to without its sum; 12 launches each of
             #1-#3 (masked on the padded batch) a rank a step, the bytes
             a rank, the host hop, step ms and peak bytes.  Its launches
             join the kernel table's and are its bert_mp_launches.
52. widedeep — bench.py's bench_widedeep: WideDeep(1,000,000, 16, 26,
             13), B=4096, Adam(1e-3) under TrainStep, then DeepFM at the
             same shape: examples/s, peak bytes, idle share; at
             bench.py's CPU size card against CPU for 3 steps, and rows
             touched only by the first batch must move later, beside a
             planted lazy table update.
53. widedeep-ps — bench.py's bench_widedeep_ps first leg:
             WideDeepHost(64, 26, 13) over a 100,000,000 x 65 adagrad host
             table (async pushes), B=16384, ids zipf(1.3) % V, PSTrainStep
             unpipelined then prefetched: examples/s, the host ms of the
             unique prep, pull and push, the idle share, the table's host
             bytes and init seconds; a step's pushed gradient against the
             per-slot gradients summed over each id, beside a push that
             does not sum them; card against CPU at bench.py's CPU size.
54. widedeep-device — bench.py's bench_widedeep_device:
             MeshShardedEmbedding(10,000,000, 65) on the card, B=16384,
             DeviceEmbeddingTrainStep at K = 1: examples/s, peak bytes,
             idle share; at bench.py's CPU size K = 2 (two threads)
             against K = 1, untouched rows unchanged, beside a dense Adam
             over the table and an exchange without the owner mask.
55. planes — the host planes on GPT-2 345M's O2 TrainStep: 3 steps under
             the tracer, a memory sample a step and the profiler: one
             train.step span a step, the step statistics, one compile and
             the cache hits, the memory gauge equal to the allocator at
             the sample, the flash kernels in the profiler's trace as
             often as their counters rose, each inside a TrainStep range;
             the synchronisations of 3 steps equal with the planes off and
             on, beside a planted loss read in the hook; zero.collective
             armed on a small ShardedUpdateTrainStep, retried bitwise.
56. widedeep-filefed — bench.py's bench_widedeep_ps file-fed leg: its
             slot files (98,304 examples) in a temporary directory, the
             native datafeed's drain at 4 threads, its 1-thread batches
             bitwise a plain Python parse, phase 53's PSTrainStep fed from
             the files, train_from_dataset through a QueueDataset and an
             InMemoryDataset after local_shuffle: examples/s, MB/s,
             finite falling losses.
57. widedeep-remote — bench.py's remote leg: a PS server process through
             SERVER_BOOT with its own 100,000,000 x 65 table, PsClient on
             the bf16 wire, PSTrainStep prefetched every step: examples/s,
             measured wire MB a step against the analytic f32 one, the
             server absent from the card's compute apps; at the small size
             remote bitwise local, unpipelined, prefetched and with ps.rpc
             armed nth=1.
58. graph — a graph at ogbn-arxiv's size sharded over two PsServers,
             GraphSAGE one-hop sampling at fanout 25 for 1,024 roots, the
             mean by segment_sum and Linear(256, 40) on the card, 20 Adam
             steps: roots/s, host ms of sampling and feature pull, idle
             share; two 8-node cliques card against CPU.

59. resnet50-filefed — bench.py's bench_resnet50_filefed: 768 JPEGs of
             256x256 from default_rng(7) in a temporary directory,
             DatasetFolder with RandomResizedCrop(224) and
             RandomHorizontalFlip (draws from random.Random), B=128,
             bench.py's collate, through IngestPipeline onto the card
             (pinned, non_blocking copies on a side stream): the pipelined
             drain (examples/s, MB/s), one process worker collating in the
             worker (timed from its first batch), the cached epoch, and
             cached-epoch O2 bf16 ResNet-50 training with Momentum(0.1,
             0.9) (samples/s, input_stall_pct); the pipelined and worker
             streams bitwise the sequential loader's, every training batch
             on the card bitwise its host array, the worker absent from
             the card's compute apps, finite losses, every parameter moved.
60. gpt-durable — bench_gpt2_345m's step at 8 of its 24 layers (B=8,
             S=1024, remat=False, O2 bf16, AdamW(1e-4); a 1.8 GB
             generation) through the durable-state plane: a sync
             generation after 2 steps, an async one while a step runs
             (its files the sync serialization of that moment by crc32
             and bytes, deep-verified), a fresh step restored from it
             taking the next 2 steps bitwise, a flipped byte walking the
             restore back a generation (ckpt_fallback_total), ZeRO at
             world size 1 loaded into a replicated TrainStep stepping on
             bitwise, numerics armed for 3 steps within 1e-5 of an f64
             recompute, a NaN in lnf_b's gradient named by
             first_bad_leaf, the synchronisations of a step armed and
             disarmed; save and load GB/s, bytes on disk, free space.
61. resilient-gpt — bench_gpt2_345m's step in ResilientTrainStep
             (snapshot_every=1, attach_durable) with the incident ring,
             numerics and replica parity armed, 6 calls, the 3rd
             poisoned by the chaos point train.step_grads: one skip and
             one restore, losses and parameters bitwise an unwrapped run
             without the poisoned batch, first_bad_leaf named, the
             incident bundle verified and referencing generation 1,
             tools/replay.py and its --bisect naming the leaf and the
             step; a run ledger record, blame of the spans and of the
             profiler's trace, a MetricsReporter pushing to a
             CollectorServer; snapshot GB/s, ms and synchronisations a
             call armed and disarmed.
62. parity-numerics — the replica parity probe at dp = 2 (LoopbackWorld
             threads, GPT-2 345M's width, 2 layers, ShardedUpdateTrainStep
             on the f32 wire): the device hash bitwise the host's, a bit
             flipped in one replica named, disarmed bitwise and with no
             added synchronisation; then ShardedTrainStep's numerics
             record at mp = 2 against an f64 recompute, beside a planted
             record without the other rank's shard.
63. ops-planes — python -m paddle_tpu_torch.distributed.launch with an
             ElasticAgent on a FileStore runs one worker (GPT-2 345M's
             width, 4 layers) that commits generations;
             elastic.worker_hang trips the progress deadline, and the
             replacement resumes from the newest generation bitwise the
             uninterrupted run; seconds to recover; the agent holds no
             context on the card.  (The autopilot leg runs in phase 57.)

The last three lines of standard output are the card's name and power limit
(nvidia-smi), one JSON object with the kernel table, and the result line
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.  It imports no JAX and nothing of paddle_tpu.
"""
from __future__ import annotations

import contextlib
import gc
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import time

# Published dense peaks of one H100 SXM (NVIDIA data sheet) at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

QUEUE_CYCLES = 500_000_000     # about 0.3 s of the card's clock
B, S = 8, 1024                 # the serving batch of GPT-2 345M
TOL_BF16 = 2e-2                # bf16 outputs: a few bf16 ulps of O(1) values
TOL_F32 = 1e-4                 # f32 outputs: summation order only
TOL_LSE = 1e-3                 # f32 lse / logz from bf16 inputs
TOL_LOSS_BF16 = 2e-2           # fused vs unfused loss in bf16 (logits rounding)
# The bf16 flash forward's output by the gradients' relative measure below
# (grad_err).  On an H100 the kernel reads 0.003-0.013 at the checked
# shapes and the plain version with p left in f32 0.006-0.024; the faults
# flash_fwd_faults plants (a skipped key tile, 8 columns of v read from the
# wrong place, the causal edge moved by one key) read 0.79 and more
# (PERF.md, Findings; tests/test_torch_flash_attention.py reads them on
# the CPU).  The check reads every planted fault on each run and fails if
# one is not above this.
TOL_FWD_BF16 = 0.05
FA_TILE = 128                  # the bf16 forward's query rows and keys a tile
FA_SEAM = 65535                # the folded B*H past which grid y once split
# bf16 gradients: max |got - want| / (|want| + rms(want)) per tensor.  Both
# sides round to bf16, so an entry may differ by an ulp of itself (2^-7 of
# |want|); the rms floor keeps an error among small gradients from hiding
# behind the few large ones.  The limit sits above the kernels' readings and
# the rounding control's (p and ds left in f32), well below what a dropped
# tile or fragment gives (PERF.md, Findings).  The bf16 flash backward's
# checks read every fault flash_bwd_faults plants on each run and fail if
# one is not above this (tests/test_torch_flash_attention.py reads them on
# the CPU).
TOL_GRAD_BF16 = 0.1
# The fused CE backward (dh, dW) by the same measure.  The smallest of the
# faults ce_bwd_faults plants is one K-step missing from one 128 x 256
# score tile (tests/test_torch_fused_ce.py reads them at a 256-token slice
# of the 345M head); p left in f32 reads about 0.01.  The check reads every
# planted fault on each run and fails if one is not above this.
TOL_CE_GRAD_BF16 = 0.03
CE_BM, CE_BN, CE_BK = 128, 256, 64   # fused_ce_bwd's output tile and K-step
CE_FWD_BN = 256                # fused_ce_fwd's vocabulary tile (bf16)
# P's scratch at the tail shape (300 tokens): 256-row chunks, so V = 1000
# runs in four chunks, the last one short
CE_TAIL_BUDGET = 2 * 300 * 256
# The flash dbias kernel's output (bf16 q, k, v) by the same measure.  A
# bf16 dbias differs from the plain version's by at most an ulp of itself
# (2^-8 of |want|); the smallest fault dbias_faults plants, one of 128
# reduced batch terms dropped, reads far above (PERF.md, Findings).  The
# check reads every planted fault on each run and fails if one is not
# above this.
TOL_DBIAS_BF16 = 0.05
TOL_MOVE = 1e-2                # an AdamW move, relative to the move itself
TOL_ADAM_MOMENT = 1e-6         # fused Adam m', v': the same f32 arithmetic
TOL_ADAM_MOVE = 1e-3           # fused Adam p' - p, relative to that move
TRAIN_STEPS = 5
MICRO = 2                      # train-fused: micro-batches of B x S each
BERT_B, BERT_S, BERT_HEADS = 128, 128, 12   # bench.py's BERT-base batch
TOL_ONES_MASK = 2e-2           # all-ones mask vs no mask, bf16 loss
LR_PEAK = 1.5e-4               # Megatron-LM's GPT-2 345M rate
CLIP_SMALL = 0.05              # binds on the small GPT's first gradients
QUANT_WIDTHS = (1, 8, 13, 127, 128, 255, 256, 384, 1024)
QUANT_ROWS = (1, 7, 300, 100_000)
ZERO_STEPS = 5                 # zero at world size 1: steps per run
ZERO_DP2_STEPS = 3             # simulated dp = 2: steps per run
# zero: the wires of bench.py's bench_gpt2_zero step, (wire, ring)
ZERO_WIRES = (("f32", False), ("bf16", False), ("int8", False),
              ("int4", False), ("int4", True))
ZERO_LEAVES = 16               # GPT's parameter tensors: #9 launches a leg
ZERO_DP2_LAYERS = 2            # simulated dp = 2: GPT-2 345M's width, 2 layers
# simulated dp = 2: |loss(quantized wire) - loss(f32 wire)| at every step.
# The quantized all-gather re-encodes the parameters each step, so at lr
# 1e-4 most moves round back onto the grid and the quantized runs partly
# stall while the f32 run falls (0.884 over the 3 steps; the int8 run left
# it by 0.333, the int4 ring by 0.451, H100 80GB HBM3 at 700 W).  The limit
# sits midway between the int4 ring and the smallest planted fault, a ring
# hop one seat off (0.647); parameters no step changes read 0.884 (PERF.md,
# Findings).  Every run is bitwise reproducible on the card.  The check
# reads the faults on each run and fails if one is not above this.
TOL_ZERO_LOSS = 0.55
RING_LEAF = 1024 * 4096        # ring primitives: values a rank, one MLP leaf
# the remat phase's forms of GPT-2 345M training: (name, the model's remat,
# TrainStep's recompute); a layer's attention runs 1 + remat + recompute
# times a step
REMAT_FORMS = (("remat=False", False, False), ("remat=True", True, False),
               ("recompute=True", False, True),
               ("remat=True, recompute=True", True, True))
# bench.py's bench_longseq_flash (accelerator leg): 8 heads of 128
LONG_B, LONG_S, LONG_S_REF = 1, 8192, 2048
LONG_LAYERS, LONG_WIDTH, LONG_HEADS, LONG_VOCAB = 4, 1024, 8, 8192
LONG_WARMUP, LONG_ITERS, LONG_ITERS_REF = 2, 3, 6
# bench.py's bench_masked_flash: (B, S, H, D), bf16, a (B, 1, 1, S) bias
MASKED_B, MASKED_S, MASKED_H, MASKED_D = 4, 2048, 16, 64
# bench.py's bench_resnet50 (accelerator leg) and bench_lenet
VISION_B, VISION_HW, VISION_STEPS = 128, 224, 5
LENET_B, LENET_WARMUP, LENET_STEPS = 256, 2, 50
SMALL_VISION_B, SMALL_VISION_HW = 8, 64     # bench_resnet50's CPU leg
# Small vision, card against CPU, by max |got - want| / (|want| + rms(want))
# (grad_err).  f32 where the comparison is continuous: a training-mode
# forward (loss, logits, every running stat) and the port's convolution and
# batch norm alone, forward and backward.  A deep ReLU network's f32
# gradients are not comparable across two implementations: a pre-activation
# within rounding of 0 takes the other side of the kink in one of them
# (5 of 24 random resnet18 states on the CPU, tools/f32_gradient_spread.py),
# so the model's gradients and one TrainStep's moves are held in f64 in
# evaluation mode, where the norms are affine and nothing rounds near a
# kink.  TOL_VISION_F32 sits above f32 summation order and below both
# faults bn_faults plants (PyTorch's momentum convention, the biased
# variance: 0.1 v / (n - 1) at the last stage's n = 32).  TOL_CONV_F32 sits
# above cuDNN's f32 algorithms (3.3e-5 at a 64-channel 3x3 stage, forward
# and backward) and below what TF32 gives there (1.3e-3; H100 80GB HBM3 at
# 700 W).  The check reads the faults and TF32 on each run.
TOL_VISION_F32 = 1e-4
TOL_VISION_F64 = 1e-9
TOL_CONV_F32 = 2e-4
# The seq2seq slice: Transformer-base as the reference's nn.Transformer
# builds it at its defaults (transformer.py:288-292), the 30,000-id
# vocabularies of PaddlePaddle's WMT14 translation example (dict_size),
# trained by its recipe: label smoothing 0.1, Adam(beta2 0.98, epsilon
# 1e-9) under NoamDecay(512, 4000); 32 sources of 256 and targets of 128
# ids, 4,096 target tokens a batch
S2S_V, S2S_D, S2S_HEADS, S2S_LAYERS, S2S_FFN = 30000, 512, 8, 6, 2048
S2S_B, S2S_SRC, S2S_TGT = 32, 256, 128
S2S_WARMUP, S2S_STEPS = 2, 8
S2S_PAD, S2S_START, S2S_END, S2S_EPS = 0, 1, 2, 0.1
# seq2seq-serve: requests of 8 sources, beam 4, at most 128 steps
SERVE_REQUESTS, SERVE_B, BEAM, MAX_STEP = 4, 8, 4, 128
# seq2seq-small: 2 + 2 layers, d_model 128, 2 heads of 64, f32
S2S_SMALL = dict(vocab=512, d_model=128, nhead=2, layers=2, ffn=256)
S2S_SMALL_STEPS, S2S_SMALL_BEAM_STEPS = 20, 16
# the best beam's log-prob against the teacher-forced rescoring of its
# tokens by the same model: f32 absolute; bf16 relative to |log-prob| (the
# incremental decode's dense attention and the full forward's kernels
# round bf16 logits at different places: 2.3e-5 to 7.3e-5 over 128 steps,
# H100 80GB HBM3 at 700 W)
TOL_RESCORE_F32 = 1e-3
TOL_RESCORE_BF16 = 1e-3
GRAD_FLOOR = 1e-4          # below: Adam normalises f32 gradient noise
# rnn: 2 layers, bidirect, hidden 512 over inputs of 512, B=128, T=50
RNN_B, RNN_T, RNN_IN, RNN_H, RNN_LAYERS = 128, 50, 512, 512, 2
# the dygraph loop (eager-small, eager-gpt, eager-vision): GPT-2 345M under
# decorate O2 with AdamW(1e-4, use_fused=True), 2 warm-ups and 8 timed
# steps; MobileNetV2 as Sandler et al. 2018 (§6.1) train it: RMSProp(0.045,
# rho 0.9, momentum 0.9), weight decay 4e-5, batch 96 at 224x224, under O1
EAGER_LR = 1e-4
EAGER_WARM, EAGER_TIMED = 2, 8
EAGER_MOVING = 3               # eager-gpt's steps at beta2 = 0.99
MB_BATCH, MB_HW, MB_LR, MB_WD = 96, 224, 0.045, 4e-5
TOL_LOSS_BF16_REL = 3.2e-2     # a loss through bf16 layers, card vs CPU
# eager-small: a 32 -> 64 -> 10 tanh MLP whose parameters carry ParamAttrs
# (a rate scale, an L1 and an L2 regulariser, a frozen bias), B=16, 3 steps
MLP_IN, MLP_HID, MLP_OUT, MLP_B, MLP_STEPS = 32, 64, 10, 16, 3
# transforms-resnet50: bench.py's file-fed recipe (bench_resnet50_filefed)
# without its ingest plane: 512 images of HW + 32 = 256 a side, one warm-up
# and 3 steps of B=128; _filefed_collate's mean and std
TF_IMAGES, TF_HW, TF_STEPS = 512, 256, 3
FF_MEAN = (0.485, 0.456, 0.406)
FF_STD = (0.229, 0.224, 0.225)
# dcgan: Radford, Metz and Chintala (arXiv:1511.06434): z of 100,
# ngf = ndf = 128 (1024 channels at 4x4), 64x64, Adam(2e-4, beta1=0.5),
# B=128; the card-vs-CPU check at ngf = ndf = 16, B=8
DCGAN_Z, DCGAN_WIDTH, DCGAN_B, DCGAN_LR = 100, 128, 128, 2e-4
DCGAN_SMALL, DCGAN_SMALL_B = 16, 8
DCGAN_WARM, DCGAN_ITERS = 2, 10
# nn-breadth: DeepSpeech2's character CTC (29 classes, B=32, T=400,
# labels up to 100) and a BiLSTM-CRF's tagging (B=64, T=50, CoNLL-03's 9
# tags); f32 values card vs CPU by scaled_err (summation order only)
CTC_B, CTC_T, CTC_C, CTC_S = 32, 400, 29, 100
CRF_B, CRF_T, CRF_TAGS = 64, 50, 9
TOL_BREADTH = 1e-5
# CTC's gradient card vs CPU at T=400: the log-domain alphas and betas
# reach about -1400, where one f32 ulp is 1.2e-4 absolute, and the gradient
# is exp(alpha + beta - logZ) - softmax, so each ulp the two devices' exp /
# log1p differ by moves it by 1.2e-4 of itself (1.24e-4 read on an H100 80GB
# HBM3 at 700 W); the limit allows 8 such ulps
TOL_CTC_GRAD = 1e-3
# resnet50-gn: Wu and He (ECCV 2018) ResNet-50 with GroupNorm(32, C) in
# place of every BatchNorm2D, at bench_resnet50's shape
GN_GROUPS = 32
# sparse-embedding: a table of GPT-2 345M's padded vocabulary and width fed
# one GPT-2 batch (B x S ids) a step; the card-vs-CPU table, 1000 x 64
SPARSE_V, SPARSE_D = 50304, 1024
SPARSE_WARM, SPARSE_STEPS = 2, 10
SPARSE_SMALL_V, SPARSE_SMALL_D, SPARSE_SMALL_STEPS = 1000, 64, 3
TOL_SPARSE = 1e-6
# norm-breadth: ResNet-50 stage 2's activation (conv2_x's output), and a
# weight-normed 1x1 convolution to the stage's 64-channel bottleneck
NB_SHAPE = (128, 256, 56, 56)
NB_CONV_OUT = 64
# rnn-amp: the recurrent layers in bf16, card vs CPU by scaled_err.  Each
# step's state is rounded to bf16 and carried through T=50 steps and 2
# layers, so the devices' 1-ulp differences in a bf16 product compound:
# 0.024-0.030 in outputs and states, 0.035-0.077 in gradients, LSTM, GRU
# and the LSTMCell, where a forget (update) gate's bias off by RNN_FAULT
# reads 1.19-2.10 (H100 80GB HBM3 at 700 W)
TOL_RNN_BF16 = 0.1
TOL_RNN_GRAD_BF16 = 0.2
RNN_FAULT = 0.5
# yolov3-dcn: PaddleDetection's yolov3_r50vd_dcn_270e_coco (the port's
# resnet50 stands for ResNet-50-vd): COCO's 9 anchors and 80 classes,
# 608x608, B=8, 50 gt rows an image of which 20 are boxes, Momentum(1e-3,
# 0.9) with L2 5e-4, f32; the card-vs-CPU check at resnet18, 128x128, B=2,
# 4 classes
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_MASKS = ([6, 7, 8], [3, 4, 5], [0, 1, 2])
YOLO_DOWN = (32, 16, 8)
YOLO_CLASSES, YOLO_B, YOLO_HW, YOLO_STEPS = 80, 8, 608, 5
YOLO_GT, YOLO_REAL = 50, 20
YOLO_IGNORE, YOLO_LR, YOLO_DECAY, YOLO_CONF = 0.7, 1e-3, 5e-4, 0.005
YOLO_SMALL_B, YOLO_SMALL_HW, YOLO_SMALL_CLASSES = 2, 128, 4
# det-ops: Mask R-CNN R50-FPN's P2 (stride 4) of two 800x1344 images, 512
# RoIs an image (its RoI heads' sample); SSD300's 38x38 map
DET_MAP = (2, 256, 200, 336)
DET_IMG = (800, 1344)
DET_ROIS, DET_SCALE, DET_CHECK = 512, 0.25, 64
SSD_MAP = 38
# yolov3-dcn serve's NMS: PaddleDetection's YOLOv3 MultiClassNMS; the
# reference's matrix_nms defaults but score_threshold (PP-YOLO serves
# YOLOv3-DCN through Matrix NMS)
YOLO_NMS = dict(score_threshold=0.01, nms_top_k=1000, keep_top_k=100,
                nms_threshold=0.45, background_label=-1)
YOLO_MATRIX = dict(score_threshold=0.01, nms_top_k=400, keep_top_k=100)
# faster-rcnn: PaddleDetection's faster_rcnn_r50_fpn_1x_coco
# (configs/faster_rcnn/_base_/faster_rcnn_r50_fpn.yml): ResNet-50, FPN of
# 256 channels on C2-C5 with P6 by a stride-2 max pool, anchors 32-512 at
# strides 4-64 and ratios 0.5 / 1 / 2, RPN 256 an image (fg 0.5, 0.7 /
# 0.3), proposals pre 2000 / post 1000 a level in training and 1000 /
# 1000 in test (NMS 0.7), 1000 collected an image, 512 RoIs an image (fg
# 0.25, 0.5 / 0.5 / 0.0, weights 0.1, 0.1, 0.2, 0.2), RoIAlign 7x7 at P2-P5
# (refer level 4 at 224), TwoFCHead of 1024, 81 classes, 800x1344;
# Momentum(0.01, 0.9) with L2 1e-4 after a linear warmup from 0.1 x over
# 1000 steps (optimizer_1x.yml), B=2 (the recipe: one image a card on 8
# cards), f32; the serve's MultiClassNMS (background 0, 0.05, NMS 0.5,
# 100 kept).  The card-vs-CPU check at resnet18, P4-P5, 128x128, 4
# classes
FRCNN_RATIOS = (0.5, 1.0, 2.0)
FRCNN_ROI = 7
FRCNN_REG_W = (0.1, 0.1, 0.2, 0.2)
FRCNN_RPN_BATCH, FRCNN_COLLECT = 256, 1000
FRCNN_SERVE = dict(score_threshold=0.05, nms_threshold=0.5, keep_top_k=100,
                   background_label=0)
FRCNN_FULL = dict(img=(800, 1344), gt=20, classes=81, stages=(2, 3, 4, 5),
                  p6=True, fpn=256, fc=1024, sizes=(32, 64, 128, 256, 512),
                  strides=(4, 8, 16, 32, 64), roi_levels=(2, 5),
                  refer=(4, 224), train_proposals=(2000, 1000),
                  test_proposals=(1000, 1000), roi_batch=512)
FRCNN_SMALL = dict(img=(128, 128), gt=6, classes=5, stages=(4, 5), p6=False,
                   fpn=64, fc=128, sizes=(32, 64), strides=(16, 32),
                   roi_levels=(4, 5), refer=(5, 64),
                   train_proposals=(200, 100), test_proposals=(100, 100),
                   roi_batch=64)
FRCNN_B, FRCNN_SMALL_B, FRCNN_STEPS = 2, 2, 5
FRCNN_LR, FRCNN_DECAY, FRCNN_WARMUP = 0.01, 1e-4, 1000
FRCNN_ANCHORS = 268_569
# det-tail: SSD300 (ssd_vgg16_300_240e_voc: maps 38-1, min / max sizes,
# ratios, steps; 21 VOC classes; B=8, 20 gt boxes an image), RetinaNet
# R50-FPN (Lin et al. 2017: P3-P7, 3 octave scales from 4 x the stride,
# 3 ratios, 80 classes; inference at 0.05, 1,000 a level, NMS 0.5, 100
# kept), Mask R-CNN's mask targets (resolution 28), EAST (a 512x512 image
# at stride 4), FOTS's RoIRotate (Liu et al. 2018: the shared features at
# 1/4 of a 640x640 image, 32 channels, text warped to height 8; this
# script's reading, 64 quads warped to 8 x 64), Faster R-CNN serve's
# 2,000 RoIs for box_decoder_and_assign
SSD_MAPS = ((38, 30.0, 60.0, (2.0,), 8), (19, 60.0, 111.0, (2.0, 3.0), 16),
            (10, 111.0, 162.0, (2.0, 3.0), 32),
            (5, 162.0, 213.0, (2.0, 3.0), 64), (3, 213.0, 264.0, (2.0,), 100),
            (1, 264.0, 315.0, (2.0,), 300))
SSD_PRIORS, SSD_CLASSES, SSD_B, SSD_GT = 8732, 21, 8, 20
RETINA_IMG, RETINA_STRIDES = (800, 1344), (8, 16, 32, 64, 128)
RETINA_ANCHORS, RETINA_CLASSES = 201_600, 80
RETINA_OUT = dict(score_threshold=0.05, nms_top_k=1000, keep_top_k=100,
                  nms_threshold=0.5)
MASK_RES, EAST_MAP, DEC_ROIS = 28, 128, 2000
PERSP = dict(map=(1, 32, 160, 160), rois=64, out=(8, 64), scale=0.25)
# gpt-eval (37): the evaluation's cut-offs, and the CPU copy's rows and
# parameter values
EVAL_TOPK, EVAL_P, EVAL_Q = 40, 0.9, (0.5, 0.9, 0.99)
CPU_ROWS, CPU_PARAMS = 64, 1 << 20
# tensor-probe (38): the ridge's lambda is PROBE_LAMBDA times the mean
# eigenvalue of X^T X / N; the 64-row CPU copy takes a larger lambda, which
# keeps its rank-64 system's condition number near 10^2
PROBE_LAMBDA, PROBE_LAMBDA_64 = 1e-3, 1e-1
# gpt-checkpoint (39): eager-gpt's loop under CosineAnnealingDecay(EAGER_LR,
# T_max); gpt-sample (40): an 8 x 992 prompt, 32 new tokens a row,
# topk(40) then the nucleus at 0.9; bert-ragged (41): 128 sentences of
# 8-128 tokens; the samplers' draws in its breadth
CKPT_T_MAX = 100
SAMPLE_PROMPT, SAMPLE_NEW, SAMPLE_TOPK, SAMPLE_P = 992, 32, 40, 0.9
SAMPLE_SEED = 40
RAGGED_MIN = 8
SAMPLER_DRAWS = 10 ** 7
# f32 bounds of the probe's invariants: a backward-stable solve or
# decomposition leaves a residual of a few n * eps (n = 1,024, eps =
# 6e-8); two solutions of A W = B agree to about cond(A) * eps
TOL_RESID = 1e-4               # ||A W - B|| / (||A|| ||W||), reconstructions
TOL_ORTHO = 1e-4               # max |Q^T Q - I|
TOL_AGREE = 1e-2               # ||W_i - W_solve|| / ||W_solve||


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


class PhaseClock:
    """Each phase's wall time, logged as ``<name> phase (<n>): <s> s of
    wall time`` when the next phase begins (or at ``end()``); every phase
    of main() runs under it, and the JSON row carries the seconds as
    ``phase_wall_s``."""

    def __init__(self):
        self.seconds = {}
        self._open = None

    def begin(self, n, name):
        self.end()
        self._open = (n, name, time.perf_counter())

    def end(self):
        if self._open is None:
            return
        n, name, t0 = self._open
        self._open = None
        self.seconds[n] = time.perf_counter() - t0
        log(f"{name} phase ({n}): {self.seconds[n]:.1f} s of wall time")


INIT_DRAWS_KEPT = 6             # configurations whose initial draws are kept


def draw_once():
    """Make GPT's and BERT's ``init_params`` draw each configuration's
    initial parameters once in this process: the script builds GPT-2 345M
    from the same seed many times, and each draw of its 355 M normals
    takes ~8 s of one host core.  A later build gets a copy of the same
    arrays (the values are those of a fresh draw: one seeded stream a
    configuration); the newest INIT_DRAWS_KEPT configurations are kept.
    The draws run on one background thread; returns ``prefetch(config)``,
    which starts a configuration's draw without waiting for it (main
    starts GPT-2 345M's and BERT-base's while nvcc builds the kernels)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.models import bert, gpt
    pool = ThreadPoolExecutor(1)
    modules = {}
    for mod, fields in ((gpt, ()), (bert, ("type_vocab_size",))):
        draw, kept, lock = mod.init_params, {}, threading.Lock()

        def drawn(c, draw=draw, kept=kept, lock=lock, fields=fields):
            key = tuple(getattr(c, f) for f in (
                "seed", "initializer_range", "num_layers", "hidden_size",
                "ffn_size", "vocab_size", "max_seq_len") + fields)
            with lock:
                if key not in kept:
                    if len(kept) >= INIT_DRAWS_KEPT:
                        kept.pop(next(iter(kept)))
                    kept[key] = pool.submit(draw, c)
                kept[key] = kept.pop(key)            # the newest last
                return kept[key]

        def init_params(c, drawn=drawn):
            return {n: a.copy() for n, a in drawn(c).result().items()}
        mod.init_params = init_params
        modules[mod.__name__.rsplit(".", 1)[1]] = drawn

    def prefetch(c):
        modules["bert" if hasattr(c, "type_vocab_size") else "gpt"](c)
    return prefetch


def cuda_ms(fn, reps=10, warmup=2):
    """Mean milliseconds of fn() on the card, between CUDA events.  The
    timed launches queue up behind a sleeping kernel, so a stall of the
    host (which shares its cores) leaves no gap between them.  The sleep
    is ``torch.cuda._sleep``, a private PyTorch API: a PyTorch without it
    fails here."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def ce_bwd_pass_ms(fn, calls=3):
    """Device ms of each pass of the bf16 fused CE backward ("p", "dw",
    "dh": its kernels ce_bwd_<pass>_pass summed over the chunks), mean of
    ``calls`` calls of fn traced by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {"p": 0.0, "dw": 0.0, "dh": 0.0}
    for evt in prof.key_averages():
        for k in ms:
            if f"ce_bwd_{k}_pass" in evt.key:
                ms[k] += evt.self_device_time_total / 1e3 / calls
    if not all(ms.values()):
        fail(f"the profiler saw no time in a fused_ce_bwd pass: {ms}")
    return ms


def bound(flops, nbytes, peak_flops):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(a, b):
    """max |a - b| over entries where both are finite; the non-finite
    entries (lse = -inf of an empty row) must match exactly."""
    import torch
    a, b = a.float(), b.float()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa], b[~fb]):
        fail("non-finite entries differ between kernel and plain version")
    return float((a[fa] - b[fb]).abs().max()) if fa.any() else 0.0


def visible_pairs(sq, sk, causal):
    """(query, key) pairs the causal, end-aligned mask leaves visible."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, max(0, i + off + 1)) for i in range(sq))


def grad_err(a, b):
    """(max |a - b| / (|b| + rms(b)), max |a - b|); a must be finite."""
    import torch
    a, b = a.float(), b.float()
    if not bool(torch.isfinite(a).all()):
        fail("a kernel gradient is not finite")
    d = (a - b).abs()
    rms = b.pow(2).mean().sqrt()
    return float((d / (b.abs() + rms).clamp_min(1e-30)).max()), float(d.max())


def rand(g, shape, dtype, scale=1.0):
    import torch
    return (torch.randn(shape, generator=g, device=g.device)
            * scale).to(dtype)


def flash_fwd_faults(fa, qt, kt, vt, scale, causal, mask=None):
    """What a faulty bf16 forward would return, as a list of (name, out):
    the plain version with one fault of the tiled design planted, in the
    middle folded slice and the middle of the FA_TILE-row query tiles that
    see a key: the tile skips its first key tile; the first key tile's v
    columns 8..15 are read from columns 16..23 (for every query row of the
    slice); and, causal only, every row's causal edge moves one key on.
    The measure must read each above its limit."""
    import torch
    s = fa._scores(qt, kt, scale, causal, mask)
    bh, sq, sk = s.shape
    b0 = bh // 2
    first = max(0, sq - sk) // FA_TILE if causal else 0
    r0 = (first + -(-sq // FA_TILE)) // 2 * FA_TILE
    bad = s.clone()
    bad[b0, r0:r0 + FA_TILE, :FA_TILE] = float("-inf")
    out = [("skips a key tile", fa._attend(bad, vt, qt.dtype)[0])]
    vb = vt.clone()
    vb[b0, :FA_TILE, 8:16] = vt[b0, :FA_TILE, 16:24]
    out.append(("reads 8 columns of v from the wrong place",
                fa._attend(s, vb, qt.dtype)[0]))
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(
            sk - sq + 1)
        moved = fa._scores(qt, kt, scale, False, mask).masked_fill(
            ~keep, float("-inf"))
        out.append(("moves the causal edge by one key",
                    fa._attend(moved, vt, qt.dtype)[0]))
    return out


def fwd_err(fa, out_k, out_p, qt, kt, vt, scale, causal, mask=None):
    """The bf16 forward's output by the relative measure: (the kernel's
    reading, the rounding control's (the plain version with p left in
    f32), [(fault, its reading)]).  Fails if the limit would pass a
    planted fault."""
    rel = grad_err(out_k, out_p)[0]
    ctl = fa.flash_attention_reference(qt.float(), kt.float(), vt.float(),
                                       scale, causal, mask)[0]
    ctl = grad_err(ctl.to(out_p.dtype), out_p)[0]
    faults = [(name, grad_err(bad, out_p)[0]) for name, bad in
              flash_fwd_faults(fa, qt, kt, vt, scale, causal, mask)]
    if min(r for _, r in faults) <= TOL_FWD_BF16:
        fail("the forward's limit would pass a planted fault: "
             + ", ".join(f"{n} {r:.3g}" for n, r in faults))
    return rel, ctl, faults


def check_flash(g, fa, case, slices=None):
    """The forward kernel against flash_attention_reference: out and lse
    by their absolute limits; in bf16 also out by the relative measure
    beside its rounding control and planted faults, and two calls bitwise
    equal.  ``slices``: compare only these folded slices (B*H past the
    seam), without faults.  Returns the largest absolute error of out."""
    import torch
    bh, sq, sk, d, dtype, causal = case
    qt = rand(g, (bh, sq, d), dtype)
    kt, vt = rand(g, (bh, sk, d), dtype), rand(g, (bh, sk, d), dtype)
    scale = 1.0 / math.sqrt(d)
    out_k, lse_k = fa._launch(qt, kt, vt, scale, causal)
    again = fa._launch(qt, kt, vt, scale, causal)
    torch.cuda.synchronize()
    same = torch.equal(out_k, again[0]) and torch.equal(lse_k, again[1])
    del again
    if slices is not None:
        idx = torch.tensor(slices, device=qt.device)
        qt, kt, vt, out_k, lse_k = (t[idx] for t in (qt, kt, vt, out_k,
                                                     lse_k))
    out_p, lse_p = fa.flash_attention_reference(qt, kt, vt, scale, causal)
    torch.cuda.synchronize()
    bf = dtype == torch.bfloat16
    tol = TOL_BF16 if bf else TOL_F32
    e_out, e_lse = max_err(out_k, out_p), max_err(lse_k, lse_p)
    ok = same and e_out <= tol and e_lse <= (TOL_LSE if bf else TOL_F32)
    detail = ""
    if bf:
        rel, ctl = grad_err(out_k, out_p)[0], None
        if slices is None:
            rel, ctl, faults = fwd_err(fa, out_k, out_p, qt, kt, vt, scale,
                                       causal)
        ok = ok and rel <= TOL_FWD_BF16
        detail = (f", relative to |ref| + rms(ref) {rel:.3g}"
                  + (f" (rounding control {ctl:.3g}; planted faults "
                     + ", ".join(f"{n} {r:.3g}" for n, r in faults) + ")"
                     if ctl is not None else "")
                  + f" (tol {TOL_FWD_BF16:g})")
    if causal and sq > sk and float(out_k[:, :sq - sk].abs().max()) != 0:
        ok = False                        # rows with no key: out = 0
    where = "" if slices is None else f" slices {list(slices)}"
    log(f"check flash_attention bh={bh} sq={sq} sk={sk} d={d} "
        f"{str(dtype)[6:]} causal={causal}{where}: max_abs_err "
        f"out={e_out:.3g} lse={e_lse:.3g} (tol {tol:g}){detail}, bitwise "
        f"repeat {'yes' if same else 'NO'} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("flash_attention kernel disagrees with its plain version")
    return e_out


def _bwd_grads(fa, s, lse, delta, qt, kt, vt, dot, scale):
    """(dq, dk, dv) of the plain backward from the f32 masked scores s and
    the given lse and delta rows, as flash_attention_bwd_reference computes
    them; with p and ds (f32)."""
    import torch
    dt = qt.dtype
    live = torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(s - torch.where(live, lse[..., None],
                                                    0.0)), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", dot.float(), vt.float())
    ds = p * (dp - delta[..., None])
    return _grads_of(p, ds, qt, kt, dot, scale, dt), p, ds


def _grads_of(p, ds, qt, kt, dot, scale, dt):
    import torch
    ds_r = ds.to(dt).float()
    return (
        (torch.einsum("bqk,bkd->bqd", ds_r, kt.float()) * scale).to(dt),
        (torch.einsum("bqk,bqd->bkd", ds_r, qt.float()) * scale).to(dt),
        torch.einsum("bqk,bqd->bkd", p.to(dt).float(), dot.float()).to(dt))


def flash_bwd_faults(fa, qt, kt, vt, ot, lse, dot, scale, causal, mask=None):
    """What a faulty bf16 backward would return, as a list of (name, (dq,
    dk, dv)): the plain version with one fault of the tiled design planted,
    in the middle folded slice and the middle of the FA_TILE-row query
    tiles that see a key: that query tile's dq skips the first 128-key
    tile; the first key tile's dk and dv skip that query tile of their
    walk; that key tile's dv reads do's columns 8..15 from columns 16..23
    for the tile's rows; the last query tile's lse and delta rows are read
    from the next slice (a tail copy that does not clip at Sq); and, causal
    only, every row's causal edge moves one key on.  The measure must read
    each above its limit."""
    import torch
    s = fa._scores(qt, kt, scale, causal, mask)
    bh, sq, sk = s.shape
    delta = fa._delta(dot, ot)
    want, p, ds = _bwd_grads(fa, s, lse, delta, qt, kt, vt, dot, scale)
    dt = qt.dtype
    b0 = bh // 2
    first = max(0, sq - sk) // FA_TILE if causal else 0
    r0 = (first + -(-sq // FA_TILE)) // 2 * FA_TILE
    rows, keys = slice(r0, r0 + FA_TILE), slice(0, FA_TILE)
    ds_skip, p_skip = ds.clone(), p.clone()
    ds_skip[b0, rows, keys] = 0
    p_skip[b0, rows, keys] = 0
    skip = _grads_of(p_skip, ds_skip, qt, kt, dot, scale, dt)
    out = [("dq skips a key tile", (skip[0], want[1], want[2])),
           ("dk/dv skip a query tile", (want[0], skip[1], skip[2]))]
    dob = dot.clone()
    dob[b0, rows, 8:16] = dot[b0, rows, 16:24]
    dv_bad = _grads_of(p, ds, qt, kt, dob, scale, dt)[2]
    out.append(("dv reads 8 columns of do from the wrong place",
                (want[0], want[1], dv_bad)))
    tail = slice((sq - 1) // FA_TILE * FA_TILE, sq)
    nxt = (b0 + 1) % bh
    lse_b, delta_b = lse.clone(), delta.clone()
    lse_b[b0, tail], delta_b[b0, tail] = lse[nxt, tail], delta[nxt, tail]
    out.append(("reads the tail's lse / delta from the next slice",
                _bwd_grads(fa, s, lse_b, delta_b, qt, kt, vt, dot,
                           scale)[0]))
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(
            sk - sq + 1)
        moved = fa._scores(qt, kt, scale, False, mask).masked_fill(
            ~keep, float("-inf"))
        out.append(("moves the causal edge by one key",
                    _bwd_grads(fa, moved, lse, delta, qt, kt, vt, dot,
                               scale)[0]))
    return out


def bwd_faults_err(fa, want, qt, kt, vt, ot, lse, dot, scale, causal,
                   mask=None):
    """[(fault, its reading)] of every fault flash_bwd_faults plants, by
    the gradients' measure (the largest over dq, dk, dv); fails if
    TOL_GRAD_BF16 would pass one."""
    faults = [(name, max(grad_err(b, w)[0] for b, w in zip(bad, want)))
              for name, bad in flash_bwd_faults(fa, qt, kt, vt, ot, lse, dot,
                                                scale, causal, mask)]
    if min(r for _, r in faults) <= TOL_GRAD_BF16:
        fail("the backward's limit would pass a planted fault: "
             + ", ".join(f"{n} {r:.3g}" for n, r in faults))
    return faults


def check_flash_bwd(g, fa, case, slices=None):
    """dq, dk, dv kernels against flash_attention_bwd_reference; in bf16
    by the relative measure beside the rounding control and the faults
    flash_bwd_faults plants, and two calls bitwise equal.  ``slices``:
    compare only these folded slices (B*H past the seam), without faults
    or control.  Returns the largest absolute errors (dq, dk/dv)."""
    import torch
    bh, sq, sk, d, dtype, causal = case
    qt, dot = rand(g, (bh, sq, d), dtype), rand(g, (bh, sq, d), dtype)
    kt, vt = rand(g, (bh, sk, d), dtype), rand(g, (bh, sk, d), dtype)
    scale = 1.0 / math.sqrt(d)
    if slices is None:
        ot, lse = fa.flash_attention_reference(qt, kt, vt, scale, causal)
    else:
        ot, lse = fa._launch(qt, kt, vt, scale, causal)
    got = fa._launch_bwd(qt, kt, vt, ot, lse, dot, scale, causal)
    again = fa._launch_bwd(qt, kt, vt, ot, lse, dot, scale, causal)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]))
    del again
    if slices is not None:
        idx = torch.tensor(slices, device=qt.device)
        qt, kt, vt, ot, lse, dot = (t[idx] for t in (qt, kt, vt, ot, lse,
                                                     dot))
        got = tuple(t[idx] for t in got[:3])
    want = fa.flash_attention_bwd_reference(qt, kt, vt, ot, lse, dot, scale,
                                            causal)
    torch.cuda.synchronize()
    bf = dtype == torch.bfloat16
    errs = [grad_err(a, b) for a, b in zip(got, want)]
    names = ("dq", "dk", "dv")
    ok = same
    if bf:
        ok = ok and all(e[0] <= TOL_GRAD_BF16 for e in errs)
        detail = (", relative to |ref| + rms(ref): "
                  + " ".join(f"{n}={e[0]:.3g}" for n, e in zip(names, errs)))
        if slices is None:
            # rounding control: the plain version with p and ds left in
            # f32, read by the same measure
            ctl = fa.flash_attention_bwd_reference(
                *(t.float() for t in (qt, kt, vt, ot)), lse, dot.float(),
                scale, causal)
            ctl = [grad_err(c.to(dtype), w)[0] for c, w in zip(ctl, want)]
            faults = bwd_faults_err(fa, want, qt, kt, vt, ot, lse, dot,
                                    scale, causal)
            detail += (" (rounding control "
                       + " ".join(f"{n}={c:.3g}" for n, c in zip(names, ctl))
                       + "; planted faults "
                       + ", ".join(f"{n} {r:.3g}" for n, r in faults) + ")")
        detail += f" (tol {TOL_GRAD_BF16:g})"
    else:
        ok = ok and all(e[1] <= TOL_F32 for e in errs)
        detail = f" (tol {TOL_F32:g})"
    if causal and sq > sk and float(got[0][:, :sq - sk].abs().max()) != 0:
        ok = False                        # rows with no key: dq = 0
    where = "" if slices is None else f" slices {list(slices)}"
    log(f"check flash_attention_bwd bh={bh} sq={sq} sk={sk} d={d} "
        f"{str(dtype)[6:]} causal={causal}{where}: max_abs_err "
        + " ".join(f"{n}={e[1]:.3g}" for n, e in zip(names, errs))
        + detail + f", bitwise repeat {'yes' if same else 'NO'} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("flash_attention backward kernels disagree with their plain "
             "version")
    return errs[0][1], max(errs[1][1], errs[2][1])


def check_small_train(GPT, gpt_loss, small, ids, TrainStep, AdamW):
    """A small f32 GPT on the card against the same model on the CPU:
    every parameter's gradient of gpt_loss, then one TrainStep.  Returns
    (largest absolute difference of gradients and loss, largest difference
    of a parameter's move over the size of that move)."""
    import torch
    gpu, cpu = GPT(small, device="cuda"), GPT(small, device="cpu")
    err = 0.0
    for m in (gpu, cpu):
        gpt_loss(m, ids, ids).backward()
    for name, p in cpu.named_parameters():
        err = max(err, float((getattr(gpu, name).grad.cpu() - p.grad)
                             .abs().max()))
        p.grad = getattr(gpu, name).grad = None
    old = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    losses = [float(TrainStep(m, gpt_loss, AdamW(learning_rate=1e-4))(
        ids, ids)) for m in (gpu, cpu)]
    err = max(err, abs(losses[0] - losses[1]))
    move_err = 0.0
    for name, p in cpu.named_parameters():
        want = p.detach() - old[name]
        got = getattr(gpu, name).detach().cpu() - old[name]
        if not bool(want.abs().max() > 0):
            fail(f"one AdamW step left {name} where it was")
        move_err = max(move_err, float((got - want).abs().max()
                                       / want.abs().max()))
    return err, move_err


def _heaviest_tile(x, tq, tk, tiles=None):
    """(row slice, key slice) of the tq x tk tile of the 2-D x with the
    largest sum of |x|, among ``tiles`` ((row, key) corners) when given."""
    rows, keys = x.shape
    tq = min(tq, rows)
    if tiles is None:
        tiles = [(r, c) for r in range(0, rows, tq)
                 for c in range(0, keys, tk)]
    mass = [float(x[r:r + tq, c:c + tk].abs().sum()) for r, c in tiles]
    r, c = tiles[mass.index(max(mass))]
    return slice(r, r + tq), slice(c, c + tk)


def dbias_faults(fa, qt, kt, vt, ot, lse, dot, scale, causal, mask):
    """What a faulty dbias kernel would return, as a list of (name, dbias
    in the bias's dtype): the plain version's ds with one fault of the
    split design planted, at the bf16 kernel's tile (fa.DBIAS_TILES) and
    splits (fa.dbias_plan).  A block skips the last term of its run (the
    last reduced (b, h) slice; when the bias has one query row, only that
    slice's last query tile), or leaves an output tile unwritten; with
    more than one split, the ordered pass drops the middle split; with
    more than one bias slice, a tile of the middle slice reads the next
    slice's bias; under the causal mask a tile that crosses the diagonal
    is skipped.  Each tile fault takes the tile of its kind that the
    masks leave the most gradient in.  Dropping one of many reduced terms
    is the smallest fault: one of 128 batch terms in the learned-bias
    encoder.  The measure must read each above its limit."""
    import torch
    bh, sq, d = qt.shape
    sk = kt.shape[1]
    tq, tk = fa.DBIAS_TILES[d]
    n_r, _, per, n_split = fa.dbias_plan(mask, bh, sq, sk, d)
    _, ds = fa._p_ds(qt, kt, vt, ot, lse, dot, scale, causal, mask)
    bb, hb, sqb, _ = mask.bias.shape
    h, n_g = mask.heads, bb * hb
    good = fa._reduce_dbias(ds, mask)
    out = []
    skip = ds.view(-1, h, sq, sk).clone()
    skip[-1 if bb == 1 else slice(None), -1 if hb == 1 else slice(None),
         slice(-tq, None) if sqb == 1 else slice(None)] = 0
    out.append(("skips the last reduced term",
                fa._reduce_dbias(skip.view_as(ds), mask)))
    unwritten = good.clone()
    flat = unwritten.view(-1, sqb, sk)
    flat[0][_heaviest_tile(flat[0].float(), tq, tk)] = 0
    out.append((f"leaves a {tq}x{tk} output tile unwritten", unwritten))
    if n_split > 1:
        # the folded slices of the middle split's run of r
        m = n_split // 2
        r = torch.arange(bh, device=ds.device)
        r = r if bb == 1 and hb == 1 else r // h if bb == 1 else r % h
        drop = ds.clone()
        drop[(r >= m * per) & (r < min(n_r, (m + 1) * per))] = 0
        out.append((f"drops split {m} of {n_split} from the ordered pass",
                    fa._reduce_dbias(drop, mask)))
    if n_g > 1:
        g0 = n_g // 2
        wrong = mask.bias.clone()
        wrong.view(-1, sqb, sk)[g0] = mask.bias.view(-1, sqb, sk)[
            (g0 + 1) % n_g]
        _, ds_w = fa._p_ds(qt, kt, vt, ot, lse, dot, scale, causal,
                           mask._replace(bias=wrong))
        bad_g = fa._reduce_dbias(ds_w, mask).view(-1, sqb, sk)[g0]
        good_g = good.view(-1, sqb, sk)[g0]
        tile = _heaviest_tile(bad_g.float() - good_g.float(), tq, tk)
        bad = good.clone()
        bad.view(-1, sqb, sk)[g0][tile] = bad_g[tile]
        out.append(("a tile reads the next bias slice", bad))
    if causal:
        # the (query tile, key tile) pairs with keys on both sides of the
        # end-aligned diagonal
        off = sk - sq
        cross = [(q0, k0) for q0 in range(0, sq, tq)
                 for k0 in range(0, sk, tk)
                 if k0 <= q0 + tq - 1 + off and k0 + tk - 1 > q0 + off]
        rows, keys = _heaviest_tile(ds.abs().sum(0), tq, tk, cross)
        diag = ds.clone()
        diag[:, rows, keys] = 0
        out.append(("skips a causal diagonal tile",
                    fa._reduce_dbias(diag, mask)))
    return out


def ce_peak_tile(v):
    """The vocabulary tile of CE_FWD_BN rows that ce_fwd_inputs fills with
    every row's largest logits: the middle one."""
    return -(-v // CE_FWD_BN) // 2


def ce_fwd_inputs(g, n, hd, v, dtype):
    """h (n, hd) and W (v, hd) whose logits put each fault ce_fwd_faults
    plants where it shows (random logits hide them: a tile is 256 of
    50,304 columns).  Every row's largest logit lies in the middle
    vocabulary tile: row i carries a code c_(i mod 256), W's row j of that
    tile 0.02 c_j, so the logit is about 0.02 |c|^2 = 20, and the rows'
    logz differ by about 1.  Every fifth row is -64 u against a component
    0.5 u of every W row (u a unit vector): its logits lie near -32, so the
    columns past V, which read zeros and score 0 unless masked, would
    dominate its sum."""
    import torch
    dev = g.device
    u = torch.randn(hd, generator=g, device=dev)
    u = u / u.norm()
    code = torch.randn(CE_FWD_BN, hd, generator=g, device=dev)
    rows = torch.arange(n, device=dev)
    h = torch.randn(n, hd, generator=g, device=dev) + code[rows % CE_FWD_BN]
    h[rows % 5 == 4] = -64.0 * u
    w = 0.02 * torch.randn(v, hd, generator=g, device=dev) + 0.5 * u
    v0 = ce_peak_tile(v) * CE_FWD_BN
    v1 = min(v, v0 + CE_FWD_BN)
    w[v0:v1] += 0.02 * code[:v1 - v0]
    return h.to(dtype), w.to(dtype)


def ce_fwd_faults(h, w):
    """What a faulty bf16 logz kernel would return, as a list of (name,
    logz): the plain version with one fault of the tiled design planted.
    In the middle 128-token tile, its 128 x 256 tile of the middle
    vocabulary tile misses the middle 64-column K-slice; the columns past
    V (which read zeros) score 0 instead of -inf; the merge drops the
    middle vocabulary tile; where N is not a multiple of 128, the rows of
    the last token tile read the next row (the last one, past N, zeros).
    The measure must read each above TOL_LSE."""
    import torch
    hf, wf = h.float(), w.float()
    (n, hd), v = h.shape, w.shape[0]
    s = hf @ wf.T
    logz = torch.logsumexp(s, -1)
    v0 = ce_peak_tile(v) * CE_FWD_BN
    v1 = min(v, v0 + CE_FWD_BN)
    tn = -(-n // CE_BM) // 2 * CE_BM            # the middle token tile
    rows = slice(tn, min(n, tn + CE_BM))
    k0 = hd // CE_BK // 2 * CE_BK
    sk = s[rows].clone()
    sk[:, v0:v1] -= hf[rows, k0:k0 + CE_BK] @ wf[v0:v1, k0:k0 + CE_BK].T
    bad = logz.clone()
    bad[rows] = torch.logsumexp(sk, -1)
    out = [("a tile misses a K-slice", bad)]
    pad = -(-v // CE_FWD_BN) * CE_FWD_BN - v
    if pad:
        out.append(("columns past V unmasked", torch.logaddexp(
            logz, torch.full_like(logz, math.log(pad)))))
    out.append(("the merge drops a vocabulary tile", torch.logaddexp(
        torch.logsumexp(s[:, :v0], -1), torch.logsumexp(s[:, v1:], -1))))
    if n % CE_BM:
        t0 = n // CE_BM * CE_BM
        nxt = torch.cat([hf[t0 + 1:], hf.new_zeros(1, hd)])
        bad = logz.clone()
        bad[t0:] = torch.logsumexp(nxt @ wf.T, -1)
        out.append(("a tail row reads the next row", bad))
    return out


def check_ce(g, fused_ce, case):
    """The logz kernel against ce_logz_reference; two calls must be
    bitwise equal.  bf16 runs on ce_fwd_inputs, and every fault
    ce_fwd_faults plants must read above TOL_LSE.  Returns the largest
    absolute error."""
    import torch
    n, hd, v, dtype = case
    bf = dtype == torch.bfloat16
    if bf:
        h, w = ce_fwd_inputs(g, n, hd, v, dtype)
    else:
        h, w = rand(g, (n, hd), dtype), rand(g, (v, hd), dtype, 0.02)
    lz_k = fused_ce._launch(h, w)
    again = fused_ce._launch(h, w)
    lz_p = fused_ce.ce_logz_reference(h, w)
    torch.cuda.synchronize()
    same = torch.equal(lz_k, again)
    tol = TOL_LSE if bf else TOL_F32
    e = max_err(lz_k, lz_p)
    ok = same and e <= tol
    detail = ""
    if bf:
        faults = [(name, max_err(bad, lz_p))
                  for name, bad in ce_fwd_faults(h, w)]
        ok = ok and min(r for _, r in faults) > tol
        detail = (" (planted faults " + ", ".join(
            f"{name} {r:.3g}" for name, r in faults) + ")")
    log(f"check fused_ce logz n={n} h={hd} v={v} {str(dtype)[6:]}: "
        f"max_abs_err={e:.3g} (tol {tol:g}){detail}, bitwise repeat "
        f"{'yes' if same else 'NO'} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("fused_ce kernel disagrees with its plain version, or its "
             "limit fails the fault check")
    return e


def ce_bwd_faults(h, w, logz, g, vc):
    """What a faulty bf16 backward would return, as a list of (name, dh,
    dW) in the kernels' output dtypes: the plain version's arithmetic with
    one fault of the chunked design planted, the vocabulary in chunks of
    vc rows.  In the middle chunk (the first when there is one) and the
    middle 128-token tile: the P pass skips a 128 x 256 tile of p; the dW
    pass skips a 128 x 256 tile of dW; the dh pass skips a 128 x 256 tile
    (the chunk's share is missing from it); one score tile misses one
    64-column K-step of H; the chunk overwrites dh's f32 sum instead of
    adding to it (with two chunks or more); its dW rows land one tile
    late.  Where N or V is not a multiple of 128, p is left unmasked on
    the rows past the end, which read the rows at the start (the kernels
    read zeros there).  The measure must read each above its limit on dh
    or on dW."""
    import torch
    hf, wf, gf = h.float(), w.float(), g.float()[:, None]

    def probs(s, lz, gg):
        return (torch.exp(s - lz[:, None]) * gg).to(w.dtype).float()

    (n, hd), v = h.shape, w.shape[0]
    chunks = -(-v // vc)
    v0 = chunks // 2 * vc                    # the middle chunk
    ch = slice(v0, min(v, v0 + vc))
    tn = -(-n // CE_BM) // 2 * CE_BM         # the middle token tile
    rows = slice(tn, min(n, tn + CE_BM))
    tile = slice(v0, min(v, v0 + vc, v0 + CE_BN))   # the chunk's first
    cols = slice(0, min(hd, CE_BN))
    p = probs(hf @ wf.T, logz, gf)
    dh, dw = p @ wf, p.T @ hf
    out = []

    def add(name, bad_dh=None, bad_dw=None):
        out.append((name, dh if bad_dh is None else bad_dh,
                    dw if bad_dw is None else bad_dw))

    pt = p[rows, tile]
    a, b = dh.clone(), dw.clone()
    a[rows] -= pt @ wf[tile]
    b[tile] -= pt.T @ hf[rows]
    add("P pass skips a tile", a, b)
    b = dw.clone()
    b[v0:min(v, v0 + vc, v0 + CE_BM), cols] = 0.0
    add("dW pass skips a tile", bad_dw=b)
    a = dh.clone()
    a[rows, cols] -= p[rows, ch] @ wf[ch, cols]
    add("dh pass skips a tile", a)
    k0 = hd // CE_BK // 2 * CE_BK
    hk = hf[rows].clone()
    hk[:, k0:k0 + CE_BK] = 0.0
    d = probs(hk @ wf[tile].T, logz[rows], gf[rows]) - pt
    a, b = dh.clone(), dw.clone()
    a[rows] += d @ wf[tile]
    b[tile] += d.T @ hf[rows]
    add("a score tile misses a K-step", a, b)
    if v0 > 0:
        add("a chunk overwrites dh's sum", p[:, v0:] @ wf[v0:])
    b = dw.clone()
    nv = ch.stop - v0
    b[v0:v0 + min(CE_BM, nv)] = 0.0
    b[v0 + CE_BM:v0 + nv] = dw[v0:v0 + nv - CE_BM]
    add("a dW chunk lands a tile late", bad_dw=b)
    if v % CE_BM:
        e = CE_BM - v % CE_BM
        add("p unmasked past V", dh + probs(hf @ wf[:e].T, logz, gf)
            @ wf[:e])
    if n % CE_BM:
        e = CE_BM - n % CE_BM
        add("p unmasked past N", bad_dw=dw + probs(
            hf[:e] @ wf.T, logz[:e], gf[:e]).T @ hf[:e])
    return [(name, x.to(h.dtype), y.to(w.dtype)) for name, x, y in out]


def check_ce_bwd(g, fused_ce, case):
    """The backward kernels against ce_bwd_reference, the bf16 ones with
    P's scratch held to ``budget`` bytes (several vocabulary chunks); a
    random g with zeros on every seventh (sentinel) row.  Two calls must
    be bitwise equal.  Returns the largest absolute error of (dh, dW)."""
    import torch
    n, hd, v, dtype, budget = case
    h = rand(g, (n, hd), dtype)
    w = rand(g, (v, hd), dtype, 0.02)
    logz = fused_ce.ce_logz_reference(h, w)
    gv = torch.randn(n, generator=g, device="cuda")
    gv[::7] = 0.0
    got = fused_ce._launch_bwd(h, w, logz, gv, budget)
    again = fused_ce._launch_bwd(h, w, logz, gv, budget)
    want = fused_ce.ce_bwd_reference(h, w, logz, gv)
    torch.cuda.synchronize()
    errs = [grad_err(a, b) for a, b in zip(got, want)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if dtype == torch.bfloat16:
        vc = fused_ce.chunk_width(n, v, budget)
        ok = same and v > vc and all(e[0] <= TOL_CE_GRAD_BF16 for e in errs)
        # rounding control: the plain version with p left in f32
        ctl = fused_ce.ce_bwd_reference(h.float(), w.float(), logz, gv)
        ctl = [grad_err(c.to(dtype), b)[0] for c, b in zip(ctl, want)]
        faults = [(name, max(grad_err(x, want[0])[0],
                             grad_err(y, want[1])[0]))
                  for name, x, y in ce_bwd_faults(h, w, logz, gv, vc)]
        if min(r for _, r in faults) <= TOL_CE_GRAD_BF16:
            ok = False                    # the limit would pass a fault
        detail = (f", {-(-v // vc)} chunks of {vc}, bitwise repeat "
                  f"{'yes' if same else 'NO'}, relative to |ref| + rms(ref): "
                  f"dh={errs[0][0]:.3g} "
                  f"dW={errs[1][0]:.3g} (rounding control dh={ctl[0]:.3g} "
                  f"dW={ctl[1]:.3g}; planted faults "
                  + ", ".join(f"{name} {r:.3g}" for name, r in faults)
                  + f"; tol {TOL_CE_GRAD_BF16:g})")
    else:
        ok = same and all(e[1] <= TOL_F32 for e in errs)
        detail = f" (bitwise repeat {'yes' if same else 'NO'}; tol " \
                 f"{TOL_F32:g})"
    log(f"check fused_ce_bwd n={n} h={hd} v={v} {str(dtype)[6:]}: "
        f"max_abs_err dh={errs[0][1]:.3g} dW={errs[1][1]:.3g}{detail} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("fused_ce backward kernels disagree with their plain version")
    return errs[0][1], errs[1][1]


def fused_config(peak, clip):
    """The slice's optimizer: AdamW(use_fused=True, decay 0.01) with a
    global-norm clip and a linear warmup over 2 steps into a cosine
    decay.  Returns (scheduler, optimizer)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(peak, T_max=4),
                            warmup_steps=2, start_lr=peak / 10, end_lr=peak)
    return sched, AdamW(learning_rate=sched, weight_decay=0.01,
                        grad_clip=ClipGradByGlobalNorm(clip), use_fused=True)


def check_small_train_fused(GPT, gpt_loss, small, ids, TrainStep):
    """The small f32 GPT, card against CPU, through three TrainSteps of the
    fused configuration (fused CE, fused AdamW, a clip that binds, the
    schedule, accumulate_steps=2).  Returns (largest loss difference,
    largest difference of a parameter's move over that move)."""
    gpu, cpu = GPT(small, device="cuda"), GPT(small, device="cpu")
    old = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    losses = []
    for m in (gpu, cpu):
        sched, opt = fused_config(1e-3, CLIP_SMALL)
        step = TrainStep(m, gpt_loss, opt, accumulate_steps=MICRO)
        run = []
        for _ in range(3):
            run.append(float(step(ids, ids)))
            sched.step()
        losses.append(run)
    err = max(abs(a - b) for a, b in zip(*losses))
    move_err = 0.0
    for name, p in cpu.named_parameters():
        want = p.detach() - old[name]
        got = getattr(gpu, name).detach().cpu() - old[name]
        if not bool(want.abs().max() > 0):
            fail(f"three fused steps left {name} where it was")
        move_err = max(move_err, float((got - want).abs().max()
                                       / want.abs().max()))
    return err, move_err


def check_adam(g, fused_adam, params, peak):
    """The fused Adam kernel against fused_adam_reference on a parameter
    set, with random gradients and moments and lr_t at step 3.  Returns
    (largest relative error of m' and v', largest error of a parameter's
    move over that move, largest absolute error of p')."""
    import torch
    grads = [torch.randn(p.shape, generator=g, device="cuda") * 1e-3
             for p in params]
    m = [torch.randn(p.shape, generator=g, device="cuda") * 1e-4
         for p in params]
    v = [torch.randn(p.shape, generator=g, device="cuda").square() * 1e-8
         for p in params]
    t = 3
    lr_t = torch.full((len(params),), peak * math.sqrt(1 - 0.999 ** t)
                      / (1 - 0.9 ** t), device="cuda")
    wd_lr = torch.tensor(peak * 0.01, device="cuda")
    args = (lr_t, wd_lr, 0.9, 0.999, 1e-8)
    got = fused_adam._launch(params, grads, m, v, *args)
    want = fused_adam.fused_adam_reference(params, grads, m, v, *args)
    torch.cuda.synchronize()
    mom_err = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                  for a, b in zip(got[1] + got[2], want[1] + want[2]))
    move_err = max(float((a - b).abs().max() / (b - p).abs().max())
                   for a, b, p in zip(got[0], want[0], params))
    p_err = max(float((a - b).abs().max()) for a, b in zip(got[0], want[0]))
    timing = (grads, m, v, args)
    return mom_err, move_err, p_err, timing


def bert_batch(vocab, b, s, seed=0):
    """bench.py's BERT batch, drawn in its order: ids, 15 % MLM labels, NSP
    labels, then per-sample lengths in [S/2, S].  Returns (ids, mlm, nsp,
    attention mask (1 = real token), mlm with -100 on the padding) as
    int32 numpy arrays."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mlm = np.where(rng.random((b, s)) < 0.15, ids, -100).astype(np.int32)
    nsp = rng.integers(0, 2, (b,)).astype(np.int32)
    lens = rng.integers(s // 2, s + 1, (b,))
    amask = np.arange(s)[None, :] < lens[:, None]
    return (ids, mlm, nsp, amask.astype(np.int32),
            np.where(amask, mlm, -100).astype(np.int32))


def padding_bias(amask):
    """BERT's additive padding bias, (B, 1, 1, S) f32 of 0 / -1e30."""
    import torch
    return torch.where(amask.bool(), 0.0, -1e30)[:, None, None, :]


def masked_case(g, fa, case):
    """Folded q, k, v, do and the mask of a check case (b, h, s, d, dtype,
    bias shape or None, bias dtype, segment ids?, causal); s is the
    sequence length of both, or (sq, sk)."""
    import torch
    b, h, s, d, dtype, bias_shape, bias_dtype, segs, _ = case
    sq, sk = (s, s) if isinstance(s, int) else s
    qt, dot = (rand(g, (b * h, sq, d), dtype) for _ in range(2))
    kt, vt = (rand(g, (b * h, sk, d), dtype) for _ in range(2))
    bias = None if bias_shape is None else rand(g, bias_shape, bias_dtype)
    q_seg = kv_seg = None
    if segs:                        # packed sequences of 96 and 64 tokens
        q_seg = (torch.arange(sq, device=qt.device) // 96).int().expand(
            b, sq).contiguous()
        kv_seg = (torch.arange(sk, device=qt.device) // 64).int().expand(
            b, sk).contiguous()
    return qt, kt, vt, dot, fa.Mask(bias, q_seg, kv_seg, h)


def check_masked(g, fa, case, mask=None, dbias=True):
    """The masked forward, dq, dk/dv and, when the case has a bias and
    ``dbias``, dbias kernels against their plain versions; in bf16 the
    forward also by the relative measure beside its rounding control and
    planted faults, and the backward beside the faults flash_bwd_faults
    and dbias_faults plant; two forward calls and two backward calls (dbias
    included) bitwise equal.  ``mask``
    replaces the case's own.  Returns the largest absolute errors (out,
    dq, dk/dv, dbias or None)."""
    import torch
    b, h, s, d, dtype, _, _, _, causal = case
    qt, kt, vt, dot, own = masked_case(g, fa, case)
    mask = own if mask is None else mask
    sc = 1.0 / math.sqrt(d)
    bf = dtype == torch.bfloat16
    want_db = dbias and mask.bias is not None
    out_k, lse_k = fa._launch(qt, kt, vt, sc, causal, mask)
    again = fa._launch(qt, kt, vt, sc, causal, mask)
    torch.cuda.synchronize()
    same = torch.equal(out_k, again[0]) and torch.equal(lse_k, again[1])
    del again
    out_p, lse_p = fa.flash_attention_reference(qt, kt, vt, sc, causal, mask)
    got = fa._launch_bwd(qt, kt, vt, out_p, lse_p, dot, sc, causal, mask,
                         dbias=want_db)
    again = fa._launch_bwd(qt, kt, vt, out_p, lse_p, dot, sc, causal, mask,
                           dbias=want_db)
    want = fa._bwd_reference(qt, kt, vt, out_p, lse_p, dot, sc, causal, mask,
                             dbias=want_db)
    torch.cuda.synchronize()
    n_out = 4 if want_db else 3
    same_bwd = all(torch.equal(a, b) for a, b in zip(got[:n_out],
                                                     again[:n_out]))
    del again
    e_out, e_lse = max_err(out_k, out_p), max_err(lse_k, lse_p)
    ok = same and same_bwd and e_out <= (TOL_BF16 if bf else TOL_F32) \
        and e_lse <= (TOL_LSE if bf else TOL_F32)
    fwd = ""
    if bf:
        r_out, ctl, faults = fwd_err(fa, out_k, out_p, qt, kt, vt, sc,
                                     causal, mask)
        ok = ok and r_out <= TOL_FWD_BF16
        fwd = (f", out relative {r_out:.3g} (rounding control {ctl:.3g}; "
               "planted faults " + ", ".join(f"{n} {r:.3g}" for n, r in
                                             faults)
               + f"; tol {TOL_FWD_BF16:g})")
        faults = bwd_faults_err(fa, want[:3], qt, kt, vt, out_p, lse_p, dot,
                                sc, causal, mask)
        fwd += (", backward's planted faults "
                + ", ".join(f"{n} {r:.3g}" for n, r in faults))
        if want_db:
            faults = [(n, grad_err(x, want[3])[0]) for n, x in dbias_faults(
                fa, qt, kt, vt, out_p, lse_p, dot, sc, causal, mask)]
            ok = ok and min(r for _, r in faults) > TOL_DBIAS_BF16
            fwd += (", dbias's planted faults "
                    + ", ".join(f"{n} {r:.3g}" for n, r in faults))
    names = ("dq", "dk", "dv", "dbias")[:4 if want_db else 3]
    errs = [grad_err(a, w) for a, w in zip(got[:len(names)], want)]
    limits = [TOL_GRAD_BF16] * 3 + [TOL_DBIAS_BF16]
    if bf:
        ok = ok and all(e[0] <= t for e, t in zip(errs, limits))
    else:
        ok = ok and all(e[1] <= TOL_F32 for e in errs)
    if want_db and (got[3].dtype != mask.bias.dtype
                    or got[3].shape != mask.bias.shape):
        ok = False
    # rows with no visible key: out = 0 and dq = 0 exactly
    empty = torch.isneginf(lse_p)
    if bool(empty.any()) and (float(out_k[empty].abs().max()) != 0
                              or float(got[0][empty].abs().max()) != 0):
        ok = False
    what = []
    if mask.bias is not None:
        what.append("bias " + "x".join(map(str, mask.bias.shape)) + " "
                    + str(mask.bias.dtype)[6:])
    if mask.q_seg is not None:
        what.append("segment ids")
    rel = (", relative to |ref| + rms(ref): "
           + " ".join(f"{n}={e[0]:.3g}" for n, e in zip(names, errs))
           + f" (tol {TOL_GRAD_BF16:g}, dbias {TOL_DBIAS_BF16:g})"
           if bf else f" (tol {TOL_F32:g})")
    log(f"check masked flash bh={b * h} s={s} d={d} {str(dtype)[6:]} "
        f"{', '.join(what)} causal={causal}: "
        f"max_abs_err out={e_out:.3g} lse={e_lse:.3g} "
        + " ".join(f"{n}={e[1]:.3g}" for n, e in zip(names, errs))
        + f"{rel}{fwd}, bitwise repeat {'yes' if same else 'NO'} "
        f"(backward {'yes' if same_bwd else 'NO'})"
        f"{'' if not bool(empty.any()) else ' (rows with no key: 0)'}"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("masked flash_attention kernels disagree with their plain "
             "versions")
    return (e_out, errs[0][1], max(errs[1][1], errs[2][1]),
            errs[3][1] if want_db else None)


def check_dbias_faults(g, fa, b, h, s):
    """The dbias kernel at the learned-bias encoder's class, a (1, H, S, S)
    bf16 bias over B*H slices, read by the bf16 measure beside every fault
    dbias_faults plants.  Fails unless two calls are bitwise equal, the
    kernel reads at most TOL_DBIAS_BF16 and every fault above it.  Returns
    the kernel's largest absolute error."""
    import torch
    qt, kt, vt, dot = (rand(g, (b * h, s, 64), torch.bfloat16)
                       for _ in range(4))
    mask = fa.Mask(rand(g, (1, h, s, s), torch.bfloat16), None, None, h)
    ot, lse = fa.flash_attention_reference(qt, kt, vt, 0.125, False, mask)
    delta = fa._delta(dot, ot)
    got = fa._launch_dbias(qt, kt, vt, dot, lse, delta, 0.125, False, mask)
    again = fa._launch_dbias(qt, kt, vt, dot, lse, delta, 0.125, False, mask)
    want = fa.flash_attention_dbias_reference(qt, kt, vt, ot, lse, dot,
                                              0.125, False, mask)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    rel, err = grad_err(got, want)
    faults = [(name, grad_err(bad, want)[0]) for name, bad in
              dbias_faults(fa, qt, kt, vt, ot, lse, dot, 0.125, False, mask)]
    ok = same and rel <= TOL_DBIAS_BF16 and \
        min(r for _, r in faults) > TOL_DBIAS_BF16
    _, _, per, n_split = fa.dbias_plan(mask, b * h, s, s, 64)
    log(f"check flash_attention_dbias bias 1x{h}x{s}x{s} bf16 over "
        f"bh={b * h} (the learned-bias encoder's class, {n_split} splits of "
        f"{per} slices, the last {b - (n_split - 1) * per}): max_abs_err="
        f"{err:.3g}, relative to |ref| + rms(ref) {rel:.3g} (planted faults "
        + ", ".join(f"{name} {r:.3g}" for name, r in faults)
        + f"; tol {TOL_DBIAS_BF16:g}), bitwise repeat "
        f"{'yes' if same else 'NO'} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the dbias kernel or its limit fails the fault check")
    return err


def check_masked_seam(g, fa):
    """The masked forward and backward with BERT's padding bias at B*H =
    70,000 (5,000 x 14 heads), past the seam where grid y once split the
    launches: the slices at both ends and on both sides of the seam
    against the plain versions."""
    import torch
    b, h, s = 5000, 14, 128
    qt, kt, vt, dot = (rand(g, (b * h, s, 64), torch.bfloat16)
                       for _ in range(4))
    keep = torch.arange(s, device="cuda")[None] < torch.randint(
        s // 2, s + 1, (b, 1), generator=g, device="cuda")
    mask = fa.Mask(padding_bias(keep), None, None, h)
    out_k, lse_k = fa._launch(qt, kt, vt, 0.125, False, mask)
    grads = fa._launch_bwd(qt, kt, vt, out_k, lse_k, dot, 0.125, False,
                           mask)[:3]
    ent = (0, FA_SEAM // h - 1, FA_SEAM // h, FA_SEAM // h + 1, b - 1)
    e_out = e_lse = rel = e_grad = rel_grad = 0.0
    for e in ent:
        sl = slice(e * h, (e + 1) * h)
        sub = fa.Mask(mask.bias[e:e + 1], None, None, h)
        out_p, lse_p = fa.flash_attention_reference(qt[sl], kt[sl], vt[sl],
                                                    0.125, False, sub)
        e_out = max(e_out, max_err(out_k[sl], out_p))
        e_lse = max(e_lse, max_err(lse_k[sl], lse_p))
        rel = max(rel, grad_err(out_k[sl], out_p)[0])
        want = fa.flash_attention_bwd_reference(
            qt[sl], kt[sl], vt[sl], out_k[sl], lse_k[sl], dot[sl], 0.125,
            False, sub)
        for a, w in zip(grads, want):
            r, err = grad_err(a[sl], w)
            rel_grad, e_grad = max(rel_grad, r), max(e_grad, err)
    ok = e_out <= TOL_BF16 and e_lse <= TOL_LSE and rel <= TOL_FWD_BF16 \
        and rel_grad <= TOL_GRAD_BF16
    log(f"check masked flash bh={b * h} s={s} d=64 bfloat16 bias {b}x1x1x{s} "
        f"float32 padding, batch entries {list(ent)} across the seam: "
        f"max_abs_err out={e_out:.3g} lse={e_lse:.3g} dq/dk/dv={e_grad:.3g},"
        f" relative out {rel:.3g}, dq/dk/dv {rel_grad:.3g} (tol "
        f"{TOL_BF16:g}, {TOL_LSE:g}, {TOL_FWD_BF16:g}, {TOL_GRAD_BF16:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the masked forward or backward disagrees past the seam")


def check_small_bert(Bert, BertConfig, bert_pretrain_loss, TrainStep, AdamW,
                     fa):
    """A 2-layer BERT (H=128, 2 heads of 64, S=128) on a padded batch, card
    against CPU, f32: MLM and NSP logits, the loss, every gradient, then
    one TrainStep with AdamW.  Returns (largest absolute difference of
    logits, loss and gradients, largest difference of a parameter's move
    over the size of that move)."""
    import torch
    kw = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=128, remat=False)
    ids, _, nsp, amask, mlm = bert_batch(512, 4, 128, seed=5)
    gpu, cpu = (Bert(BertConfig(**kw), device=d) for d in ("cuda", "cpu"))
    before = fa.launches_masked
    with torch.no_grad():
        outs = [m(ids, attention_mask=amask) for m in (gpu, cpu)]
    if fa.launches_masked != before + 2:
        fail("the small BERT did not take the masked kernel")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(*outs))
    losses = []
    for m in (gpu, cpu):
        loss = bert_pretrain_loss(m, ids, mlm, nsp, amask)
        loss.backward()
        losses.append(float(loss))
    err = max(err, abs(losses[0] - losses[1]))
    for name, p in cpu.named_parameters():
        err = max(err, float((getattr(gpu, name).grad.cpu() - p.grad)
                             .abs().max()))
        p.grad = getattr(gpu, name).grad = None
    old = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    for m in (gpu, cpu):
        TrainStep(m, bert_pretrain_loss, AdamW(learning_rate=1e-4))(
            ids, mlm, nsp, amask)
    return err, moves_err(gpu, cpu, old, "one AdamW step")


def check_small_remat(models, loss_closure, loss_and_grads):
    """Small f32 models on the card with each form of recompute (per-layer
    remat, the whole loss as one region, both): the loss and every
    gradient bitwise those of the same model without recompute; and the
    remat model on the CPU within TOL_F32 of the card.  ``models``: [(name,
    make(remat, device), loss_fn, inputs)].  Returns (the forms that were
    not bitwise, the largest card-CPU difference)."""
    import torch

    def grads(model, loss_fn, args, recompute):
        params = dict(model.named_parameters())
        dev = next(iter(params.values())).device
        return loss_and_grads(loss_closure(model, loss_fn,
                                           recompute=recompute), params,
                              [torch.as_tensor(a, device=dev) for a in args])

    bad, err = [], 0.0
    for name, make, loss_fn, args in models:
        loss_p, g_p = grads(make(False, "cuda"), loss_fn, args, False)
        for form, remat, rc in REMAT_FORMS[1:]:
            loss_r, g_r = grads(make(remat, "cuda"), loss_fn, args, rc)
            if not torch.equal(loss_r, loss_p) or not all(
                    torch.equal(g_r[n], g_p[n]) for n in g_p):
                bad.append(f"{name} {form}")
        loss_c, g_c = grads(make(True, "cpu"), loss_fn, args, False)
        err = max([err, abs(float(loss_c) - float(loss_p))]
                  + [float((g_p[n].cpu() - g_c[n]).abs().max())
                     for n in g_c])
    return bad, err


def moves_err(gpu, cpu, old, what):
    """Largest difference of a parameter's move, card against CPU, over
    the size of that move; fails on a parameter that did not move."""
    err = 0.0
    for name, p in cpu.named_parameters():
        want = p.detach() - old[name]
        got = dict(gpu.named_parameters())[name].detach().cpu() - old[name]
        if not bool(want.abs().max() > 0):
            fail(f"{what} left {name} where it was")
        err = max(err, float((got - want).abs().max() / want.abs().max()))
    return err


def biased_encoder(nn, d_model, heads, ffn, layers, s, device):
    """The learned-bias encoder: a TransformerEncoder whose src_mask is a
    (1, heads, S, S) additive bias parameter, trained with the layers."""
    import torch

    class BiasedEncoder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                d_model, heads, ffn, dropout=0.0, activation="gelu",
                device=device), layers)
            self.bias = torch.nn.Parameter(torch.zeros(
                1, heads, s, s,
                device=next(iter(self.encoder.parameters())).device))

        def forward(self, x):
            return self.encoder(x, self.bias)

    return BiasedEncoder()


def mse_loss(model, x, target):
    return (model(x).float() - target.float()).pow(2).mean()


def check_small_encoder(nn, fa):
    """A 2-layer learned-bias encoder (d_model 128, 2 heads of 64, S=128),
    card against CPU, f32: the output and every gradient, the bias's
    included.  Returns the largest absolute difference."""
    import copy

    import torch
    torch.manual_seed(0)
    cpu = biased_encoder(nn, 128, 2, 256, 2, 128, "cpu")
    with torch.no_grad():
        cpu.bias.normal_(0.0, 0.5)
    gpu = copy.deepcopy(cpu).to("cuda")
    gx = torch.Generator().manual_seed(1)
    x, target = (torch.randn(2, 128, 128, generator=gx) for _ in range(2))
    before = fa.launches_dbias
    outs = []
    for m in (gpu, cpu):
        out = m(x.to(m.bias.device))
        (out - target.to(out.device)).pow(2).mean().backward()
        outs.append(out.detach().cpu())
    if fa.launches_dbias != before + 2:
        fail("the small encoder's backward did not launch the dbias kernel "
             "once per layer")
    err = float((outs[0] - outs[1]).abs().max())
    gp = dict(gpu.named_parameters())
    for name, p in cpu.named_parameters():
        err = max(err, float((gp[name].grad.cpu() - p.grad).abs().max()))
    return err


def card_power():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def scaled_err(a, b):
    """max |a - b| / (|b| + rms(b)), grad_err's measure; a must be
    finite."""
    return grad_err(a, b)[0]


def vision_loss(m, x, y):
    from paddle_tpu_torch.nn.functional import cross_entropy
    return cross_entropy(m(x), y).mean()


def vision_batch(b, c, hw, classes, seed=0):
    """bench.py's inputs: standard normal images, then integer labels,
    from one default_rng(seed)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, c, hw, hw)).astype(np.float32),
            rng.integers(0, classes, size=(b,)))


def bn_faults():
    """Faulty batch norms for check_small_vision, by name: PyTorch's
    momentum convention (0.1 keeps 10 %) and the biased variance in the
    running update.  Each wraps the port's functional batch_norm."""
    import paddle_tpu_torch.nn.functional as PF
    real = PF.batch_norm

    def torch_momentum(x, rm, rv, *a, momentum=0.9, **kw):
        return real(x, rm, rv, *a, momentum=1 - momentum, **kw)

    def biased(x, rm, rv, *a, momentum=0.9, training=False, **kw):
        old = rv.clone()
        out = real(x, rm, rv, *a, momentum=momentum, training=training, **kw)
        if training:
            n = x.numel() // x.shape[1]
            # the unbiased statistic the update added, times (n - 1) / n
            rv.copy_(momentum * old + (rv - momentum * old) * (n - 1) / n)
        return out
    return {"torch_momentum": torch_momentum, "biased_variance": biased}


def _train_forward(model, x, y, batch_norm=None):
    """(loss, logits, {buffer: tensor}) of one training-mode forward, on
    the CPU; the port's batch_norm is replaced by ``batch_norm`` for the
    call if one is given."""
    import torch

    import paddle_tpu_torch.nn.functional as PF
    real = PF.batch_norm
    if batch_norm is not None:
        PF.batch_norm = batch_norm
    try:
        with torch.no_grad():
            out = model(x)
            loss = PF.cross_entropy(out, y).mean()
    finally:
        PF.batch_norm = real
    return loss.cpu(), out.cpu(), {n: b.cpu()
                                   for n, b in model.named_buffers()}


def _conv_bn_checks(g):
    """The port's f32 conv2d (with cuDNN's TF32 switched on around it) and
    batch_norm in training mode, forward and backward, card against CPU at
    a ResNet stage's shape; and cuDNN's own TF32 convolution, which the
    tolerance must catch.  Returns (conv, batch norm, TF32) errors."""
    import torch
    import torch.nn.functional as TF

    import paddle_tpu_torch.nn.functional as PF
    x = torch.randn(8, 64, 32, 32, generator=g, device="cuda")
    w = torch.randn(64, 64, 3, 3, generator=g, device="cuda") * 0.05
    dy = torch.randn(8, 64, 32, 32, generator=g, device="cuda")

    def run(fn, dev, *ts):
        ts = [t.detach().to(dev).requires_grad_() for t in ts]
        out = fn(*ts)
        out.backward(dy.to(dev))
        return [out.detach().cpu()] + [t.grad.cpu() for t in ts]

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        conv = lambda a, b: PF.conv2d(a, b, padding=1)         # noqa: E731
        want = run(conv, "cpu", x, w)
        conv_err = max(scaled_err(a, b) for a, b in zip(run(conv, "cuda", x, w),
                                                     want))
        tf32 = lambda a, b: TF.conv2d(a, b, padding=1)         # noqa: E731
        tf32_err = max(scaled_err(a, b) for a, b in zip(run(tf32, "cuda", x, w),
                                                     want))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    wb = torch.rand(64, generator=g, device="cuda") + 0.5
    bb = torch.randn(64, generator=g, device="cuda")
    stats = {}

    def bn(dev):
        def f(a, w_, b_):
            rm, rv = torch.zeros(64, device=dev), torch.ones(64, device=dev)
            out = PF.batch_norm(a, rm, rv, w_, b_, training=True)
            stats[dev] = (rm.cpu(), rv.cpu())
            return out
        return f
    want = run(bn("cpu"), "cpu", x * 2 + 1, wb, bb)
    got = run(bn("cuda"), "cuda", x * 2 + 1, wb, bb)
    bn_err = max(scaled_err(a, b) for a, b in zip(
        got + list(stats["cuda"]), want + list(stats["cpu"])))
    return conv_err, bn_err, tf32_err


def check_small_vision(g, resnet18, TrainStep, Momentum):
    """bench_resnet50's CPU leg, resnet18(num_classes=10) at B=8, 64x64,
    card against CPU from one state: a training-mode f32 forward (loss,
    logits, every running stat), with each of bn_faults read beside it;
    then in f64 and evaluation mode every parameter's gradient and one
    TrainStep(Momentum(0.1, 0.9)) step's parameter moves; and the port's
    convolution and batch norm alone (_conv_bn_checks).  Returns the
    readings by name."""
    import copy

    import torch
    x, y = vision_batch(SMALL_VISION_B, 3, SMALL_VISION_HW, 10, seed=2)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    torch.manual_seed(0)
    cpu = resnet18(num_classes=10, device="cpu")
    init = copy.deepcopy(cpu.state_dict())

    def on_card():
        m = resnet18(num_classes=10, device="cuda")
        m.load_state_dict(init)
        return m

    loss_c, out_c, bufs_c = _train_forward(cpu, x, y)
    loss_g, out_g, bufs_g = _train_forward(on_card(), x.cuda(), y.cuda())
    r = {"train_f32": max([scaled_err(out_g, out_c), scaled_err(loss_g, loss_c)]
                          + [scaled_err(bufs_g[n], bufs_c[n]) for n in bufs_c])}
    for name, fault in bn_faults().items():
        _, _, bufs_f = _train_forward(on_card(), x.cuda(), y.cuda(), fault)
        r[name] = max(scaled_err(bufs_f[n], bufs_c[n]) for n in bufs_c)
    # f64, evaluation mode, on the running stats the CPU forward left
    state = copy.deepcopy(cpu.state_dict())
    models = []
    for dev in ("cuda", "cpu"):
        m = resnet18(num_classes=10, device=dev).double()
        m.load_state_dict(state)
        m.eval()
        vision_loss(m, x.double().to(dev), y.to(dev)).backward()
        models.append(m)
    gp = dict(models[0].named_parameters())
    r["eval_grads_f64"] = max(scaled_err(gp[n].grad.cpu(), p.grad)
                              for n, p in models[1].named_parameters())
    old = {n: p.detach().clone() for n, p in models[1].named_parameters()}
    for m in models:
        dev = next(iter(m.parameters())).device
        TrainStep(m, vision_loss, Momentum(learning_rate=0.1, momentum=0.9))(
            x.double().to(dev), y.to(dev))
    r["eval_moves_f64"] = moves_err(models[0], models[1], old,
                                    "one Momentum step")
    r["conv_f32"], r["bn_f32"], r["tf32_conv"] = _conv_bn_checks(g)
    return r


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def quant_rows(g, r, d):
    """(r, d) f32 rows for the row quantizer: a zero row (scale 1) and, in
    the last row, 127 beside .5 ties (scale 1 on the int8 wire)."""
    import torch
    x = torch.randn(r, d, generator=g, device="cuda") * 3
    x[0] = 0.0
    if d >= 4:
        x[-1, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5])
    return x


def check_ring_quant(g, rq):
    """#9 against its plain codec, bitwise, over the boundary corpus (every
    width of QUANT_WIDTHS at every row count of QUANT_ROWS, both wires),
    then rows holding NaN or inf (their scale, and the finite rows)."""
    import torch
    n = 0
    for wire in ("int8", "int4"):
        for d in QUANT_WIDTHS:
            for r in QUANT_ROWS:
                x = quant_rows(g, r, d)
                q, s = rq._launch(x, wire)
                qp, sp = rq.ring_quant_rows_reference(x, wire)
                if not (torch.equal(q, qp) and torch.equal(s, sp)):
                    fail(f"ring_quant {wire} rows={r} d={d} differs from "
                         "its plain codec")
                n += 1
        x = quant_rows(g, 300, 256)
        x[1, 5], x[2, 7], x[3, 0] = float("nan"), float("inf"), -float("inf")
        q, s = rq._launch(x, wire)
        qp, sp = rq.ring_quant_rows_reference(x, wire)
        if not (torch.equal(s, sp) and torch.equal(q[4:], qp[4:])
                and torch.equal(q[0], qp[0]) and float(s[1]) == 1.0):
            fail(f"ring_quant {wire} rows with NaN or inf: scales or finite "
                 "rows differ from the plain codec")
        n += 1
    log(f"check ring_quant int8 and int4, widths {QUANT_WIDTHS} x rows "
        f"{QUANT_ROWS}, ties, zero rows, NaN/inf rows: {n} calls bitwise "
        "equal to the plain codec ok")


def misseated_reduce_scatter(gflat, mesh, *, chunk=256, wire="f32"):
    """A planted fault: parallel/ring.py's quantized reduce-scatter with
    every hop adding the local block one seat off."""
    import torch
    from paddle_tpu_torch.distributed.wire import (dequantize_rows_torch,
                                                   quantize_rows_torch)
    n, idx, group = mesh.shape["dp"], mesh.rank, mesh.group
    blocks = gflat.to(torch.float32).reshape(n, -1, chunk)
    q = quantize_rows_torch(blocks[(idx - 1) % n], wire)
    for t in range(n - 1):
        part = dequantize_rows_torch(group.ring_shift(q), wire) + blocks[
            (idx - t - 1) % n]
        q = quantize_rows_torch(part, wire)
    return dequantize_rows_torch(q, wire).reshape(-1)


def ring_excess(x, s, g, qmax):
    """How far the ring's reduce-scattered sums ``s`` (rank order) and a
    rank's gathered vector ``g`` exceed their envelopes, in 256-wide rows
    of the ranks' vectors ``x`` (n, L): a sum within n codec steps of the
    largest partial, n * max|row of sum_r |x_r|| / qmax (the bound of the
    reference's test_quantized_rs_tracks_exact_sum, row by row), and the
    gathered copy within one codec step of the sums.  <= 0 is sound."""
    import torch
    want = x.sum(0).view(-1, 256)
    env = x.abs().sum(0).view(-1, 256).amax(1, keepdim=True) \
        * x.shape[0] / qmax
    got = torch.cat(s).view(-1, 256)
    step = got.abs().amax(1, keepdim=True) / qmax
    return max(float(((got - want).abs() - env).max()),
               float(((g.view(-1, 256) - got).abs() - step).max()))


def check_ring_primitives(g, rq, World):
    """The int8 / int4 ring_reduce_scatter and ring_all_gather at dp = 2
    and 4, ranks simulated as threads, RING_LEAF values a rank: through #9
    bitwise the same ring on the CPU (the plain codec), every rank's
    gathered copy the same bits, within ring_excess's envelopes; a
    mis-seated hop planted outside them.  Returns the largest sound and the
    smallest faulty excess."""
    import torch
    from paddle_tpu_torch.parallel.ring import (ring_all_gather,
                                                ring_reduce_scatter)
    sound, fault = -math.inf, math.inf
    for n in (2, 4):
        x = torch.randn(n, RING_LEAF, generator=g, device="cuda")
        for wire, qmax in (("int8", 127.0), ("int4", 7.0)):
            def pair(xs, rs=ring_reduce_scatter):
                def fn(rank, mesh):
                    s = rs(xs[rank], mesh, wire=wire)
                    return s, ring_all_gather(s, mesh, wire=wire)
                return World(n).run(fn)
            got, cpu = pair(x), pair(x.cpu())
            for (s, a), (sc, ac) in zip(got, cpu):
                if not (torch.equal(s.cpu(), sc) and torch.equal(a.cpu(), ac)
                        and torch.equal(a, got[0][1])):
                    fail(f"ring dp={n} {wire}: the card's ring differs from "
                         "the CPU's or its ranks gathered different bits")
            ex = ring_excess(x, [s for s, _ in got], got[0][1], qmax)
            bad = pair(x, misseated_reduce_scatter)
            ex_bad = ring_excess(x, [s for s, _ in bad], bad[0][1], qmax)
            log(f"check ring dp={n} {wire}, {RING_LEAF} values a rank: "
                f"bitwise the CPU ring, gathered copies equal; excess over "
                f"the envelope {ex:.4g} (a mis-seated hop {ex_bad:.4g})")
            if ex > 0 or not ex_bad > 0:
                fail(f"ring dp={n} {wire}: outside its envelope, or the "
                     "envelope holds a mis-seated hop")
            sound, fault = max(sound, ex), min(fault, ex_bad)
        del x
    return sound, fault


def gradient_rows(GPT, gpt_loss, cfg, ids_t, functional_loss_call):
    """GPT-2 345M's O2 gradient of gpt_loss on one batch, each leaf flat
    and cut into 256-wide rows, as the ZeRO legs cut it: (R, 256) f32."""
    import torch
    model = GPT(cfg, device="cuda")
    params = dict(model.named_parameters())
    loss = functional_loss_call(model, gpt_loss, params, [ids_t, ids_t],
                                amp=True)
    grads = torch.autograd.grad(loss, list(params.values()))
    if any(g.numel() % 256 for g in grads):
        fail("a GPT-2 345M leaf is not a multiple of 256 values")
    return torch.cat([g.reshape(-1) for g in grads]).view(-1, 256)


def params_diff(a, b):
    """max |a - b| over every parameter of two {name: tensor} maps."""
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in a)


def zero_run(model, init, make_step, ids_t, rq, fa, steps=ZERO_STEPS):
    """``steps`` steps of ``make_step()`` from the parameters ``init`` on
    one batch: losses, the #9 and flash launch counts after each step, the
    step ms (CUDA events, the steps after the first), the peak bytes of the
    model and its step and the final parameters."""
    import torch
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    step = make_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # peak bytes of the model and its step alone: the snapshots this phase
    # holds beside them are left out
    held = torch.cuda.memory_allocated() - sum(
        p.numel() * p.element_size() for p in model.parameters())
    rq.launches = 0
    reset_fa(fa)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    losses, quant, flash = [], [], []
    for i in range(steps):
        if i == 1:
            e0.record()
        losses.append(step(ids_t, ids_t))
        quant.append(rq.launches)
        flash.append(fa_counts(fa)[:3])
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / (steps - 1)
    return {"losses": [float(x) for x in losses], "quant": quant,
            "flash": flash, "step_ms": ms,
            "peak_bytes": torch.cuda.max_memory_allocated() - held,
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "step": step}


def zero_dp2_run(models, init, make_step, ids_t, rq, World):
    """ZERO_DP2_STEPS steps on two ranks simulated as threads, each on its
    own replica: per rank, the losses, its own #9 launch count and its
    parameters after every step."""
    import torch
    with torch.no_grad():
        for m in models:
            for n, p in m.named_parameters():
                p.copy_(init[n])

    def rank_fn(rank, mesh):
        step = make_step(models[rank], mesh)
        losses, quant, snaps = [], [], []
        for _ in range(ZERO_DP2_STEPS):
            losses.append(float(step(ids_t, ids_t)))
            quant.append(rq.thread_launches())
            snaps.append({n: p.detach().clone()
                          for n, p in models[rank].named_parameters()})
        return {"losses": losses, "quant": quant, "snaps": snaps,
                "wire_bytes": getattr(step, "collective_wire_bytes",
                                      lambda: None)(),
                "opt_bytes": getattr(step, "opt_state_bytes_per_replica",
                                     lambda: None)()}
    return World(2).run(rank_fn)


FA_COUNTERS = ("launches", "launches_dq", "launches_dkv", "launches_masked",
               "launches_dq_masked", "launches_dkv_masked", "launches_dbias")


def fa_counts(fa):
    """The flash kernels' launch counts, by FA_COUNTERS."""
    return tuple(getattr(fa, n) for n in FA_COUNTERS)


def reset_fa(fa):
    for n in FA_COUNTERS:
        setattr(fa, n, 0)


def attention_times(g, fa, F, b, h, s, d, causal, amask=None):
    """masked_times at a square (b, h, s, d), causal or not, with BERT's
    padding bias of ``amask`` (B, S) when given (SDPA takes a bool mask of
    the real keys).  The work counted for a bound is what this data needs:
    the (query, key) pairs the causal edge or the padding leaves
    visible."""
    bh = b * h
    mask = keep = None
    extra = 0
    pairs = bh * (visible_pairs(s, s, True) if causal else s * s)
    if amask is not None:
        mask = fa.Mask(padding_bias(amask), None, None, h)
        keep = amask.bool()[:, None, None, :]
        extra = b * s * 4                            # the f32 bias
        pairs = h * s * int(amask.sum())
    return masked_times(g, fa, F, b, h, s, s, d, mask, keep, pairs, extra,
                        causal=causal)


def zero_phase(g, cfg, ids_t, fa):
    """Phase 9: the row quantizer #9 against its plain codec, bench.py's
    bench_gpt2_zero step at world size 1 over NCCL on every wire, and dp = 2
    simulated as two threads at GPT-2 345M's width.  Returns the readings,
    the gradient rows #9 is timed on (``grows``) and #9's launches on the
    main path by wire (``launches``)."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed.wire import wire_nbytes
    from paddle_tpu_torch.jit import TrainStep, functional_loss_call
    from paddle_tpu_torch.models import GPT, GPTConfig, gpt_loss
    from paddle_tpu_torch.ops.cuda import ring_quant
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import init_process_group, make_mesh
    from paddle_tpu_torch.parallel.dp_meta import \
        CompressedAllReduceTrainStep
    from paddle_tpu_torch.parallel.mesh import LoopbackWorld
    from paddle_tpu_torch.parallel.zero import (ShardedUpdateTrainStep,
                                                build_shard_specs)
    L = cfg.num_layers

    check_ring_quant(g, ring_quant)
    ring_ex = dict(zip(("sound", "misseated"),
                       check_ring_primitives(g, ring_quant, LoopbackWorld)))
    grows = gradient_rows(GPT, gpt_loss, cfg, ids_t, functional_loss_call)
    quant_err = 0.0
    for wire in ("int8", "int4"):
        q, s = ring_quant._launch(grows, wire)
        qp, sp = ring_quant.ring_quant_rows_reference(grows, wire)
        quant_err = max(quant_err, max_err(q, qp), max_err(s, sp))
        if not (torch.equal(q, qp) and torch.equal(s, sp)):
            fail(f"ring_quant {wire} on GPT-2 345M's gradient differs from "
                 f"its plain codec by {quant_err:.3g}")
    del q, s, qp, sp
    log(f"check ring_quant int8 and int4 on GPT-2 345M's O2 gradient in "
        f"{grows.shape[0]} rows of 256: bitwise equal to the plain codec ok")

    amp = dict(amp_level="O2", amp_dtype="bfloat16")
    init_process_group("cuda", rank=0, world_size=1,
                       init_method=f"tcp://localhost:{free_port()}")
    try:
        mesh = make_mesh({"dp": 1})
        zmodel = GPT(cfg, device="cuda")              # f32 masters
        zinit = {n: p.detach().clone() for n, p in zmodel.named_parameters()}
        log(f"zero: GPT-2 345M, world size 1 over NCCL ({dist.get_backend()}"
            f"), AdamW(learning_rate=1e-4), O2 bf16, B={B}, S={S}, "
            f"{ZERO_STEPS} steps on one batch per run, timed after the "
            "first")

        def trainstep():
            return TrainStep(zmodel, gpt_loss, AdamW(learning_rate=1e-4),
                             **amp)

        def sharded(wire, ring):
            return lambda: ShardedUpdateTrainStep(
                zmodel, gpt_loss, AdamW(learning_rate=1e-4), mesh=mesh,
                wire_dtype=wire, ring=ring, **amp)

        ref = zero_run(zmodel, zinit, trainstep, ids_t, ring_quant, fa)
        again = zero_run(zmodel, zinit, trainstep, ids_t, ring_quant, fa)
        repro = max(params_diff(again["params"], ref["params"]),
                    max(abs(a - b) for a, b in zip(again["losses"],
                                                   ref["losses"])))
        log(f"zero: TrainStep against itself, {ZERO_STEPS} steps: losses "
            f"{ref['losses']}, max |difference| of losses and parameters "
            f"{repro:.3g} ({'bitwise' if repro == 0 else 'not bitwise'})")
        del again
        zero_runs, zero_launch = {}, {}
        for wire, ring in ZERO_WIRES:
            key = f"{wire}{'-ring' if ring else ''}"
            r = zero_run(zmodel, zinit, sharded(wire, ring), ids_t,
                         ring_quant, fa)
            per = 0 if wire in ("f32", "bf16") or ring else 2 * ZERO_LEAVES
            want_q = [per * (i + 1) for i in range(ZERO_STEPS)]
            want_f = [(L * (i + 1),) * 3 for i in range(ZERO_STEPS)]
            if r["quant"] != want_q or r["flash"] != want_f:
                fail(f"zero {key}: ring_quant launches {r['quant']} != "
                     f"{want_q}, flash (fwd, dq, dk/dv) {r['flash']} != "
                     f"{want_f}")
            if not all(math.isfinite(x) for x in r["losses"]):
                fail(f"zero {key}: a loss is not finite")
            if r["losses"][0] != ref["losses"][0]:
                fail(f"zero {key}: the first loss {r['losses'][0]} is not "
                     f"the TrainStep's {ref['losses'][0]}")
            if key in ("f32", "int4-ring"):
                d = max(params_diff(r["params"], ref["params"]),
                        max(abs(a - b) for a, b in zip(r["losses"],
                                                       ref["losses"])))
                if d > repro:
                    fail(f"zero {key}: differs from TrainStep by {d:.3g}, "
                         f"more than TrainStep from itself ({repro:.3g})")
            zero_launch[key] = r["quant"][-1]
            zero_runs[key] = {
                "losses": r["losses"], "step_ms": r["step_ms"],
                "tokens_per_s": B * S / r["step_ms"] * 1e3,
                "peak_bytes": r["peak_bytes"],
                "opt_state_bytes_per_replica":
                    r["step"].opt_state_bytes_per_replica()}
            log(f"zero {key}: losses {r['losses']}, ring_quant launches "
                f"{r['quant']}, step {r['step_ms']:.3f} ms, "
                f"{B * S / r['step_ms'] * 1e3:.1f} training tokens/s, "
                f"max_memory_allocated {r['peak_bytes']} bytes")
            del r
        zero_runs["trainstep"] = {
            "losses": ref["losses"], "step_ms": ref["step_ms"],
            "tokens_per_s": B * S / ref["step_ms"] * 1e3,
            "peak_bytes": ref["peak_bytes"]}
        # the int8 step with the plain codec in place of #9: the same bits
        plain_rq = ring_quant.ring_quant_rows
        ring_quant.ring_quant_rows = ring_quant.ring_quant_rows_reference
        try:
            plain = zero_run(zmodel, zinit, sharded("int8", False), ids_t,
                             ring_quant, fa)
        finally:
            ring_quant.ring_quant_rows = plain_rq
        kern = zero_run(zmodel, zinit, sharded("int8", False), ids_t,
                        ring_quant, fa)
        d_plain = max(params_diff(kern["params"], plain["params"]),
                      max(abs(a - b) for a, b in zip(kern["losses"],
                                                     plain["losses"])))
        log(f"zero int8: the step through #9 against the step through the "
            f"plain codec, {ZERO_STEPS} steps: max |difference| of losses and "
            f"parameters {d_plain:.3g} (TrainStep against itself "
            f"{repro:.3g})")
        if plain["quant"][-1] != 0 or d_plain > repro:
            fail("zero int8 through #9 differs from the plain codec's step")
        zero_launch["int8"] += kern["quant"][-1]
        specs = build_shard_specs(zinit, 2)
        del ref, plain, kern, zmodel, zinit
        torch.cuda.empty_cache()
        wire_bytes_dp2 = {
            w: sum(wire_nbytes(s.shard_len, w, row=256)
                   for s in specs.values()) for w in ("f32", "bf16", "int8",
                                                      "int4")}
        log(f"zero: analytic wire bytes a rank ships per leg per step at "
            f"dp = 2, GPT-2 345M: {wire_bytes_dp2}")
    finally:
        dist.destroy_process_group()

    # simulated dp = 2: two ranks as threads, each on its own replica
    cfg2 = GPTConfig(hidden_size=cfg.hidden_size, num_heads=cfg.num_heads,
                     vocab_size=cfg.vocab_size, max_seq_len=S,
                     num_layers=ZERO_DP2_LAYERS, remat=False)
    models2 = [GPT(cfg2, device="cuda") for _ in range(2)]
    init2 = {n: p.detach().clone() for n, p in models2[0].named_parameters()}
    log(f"zero dp=2 (simulated: two ranks as threads on one card): GPT-2 "
        f"345M's width, {ZERO_DP2_LAYERS} layers, global batch {B} x {S}, "
        f"AdamW(learning_rate=1e-4), O2 bf16, {ZERO_DP2_STEPS} steps")

    def dp2(kind, wire="f32", ring=False, cls=ShardedUpdateTrainStep):
        def make(model, m2):
            opt = AdamW(learning_rate=1e-4)
            if kind == "replicated":
                return CompressedAllReduceTrainStep(
                    model, gpt_loss, opt, mesh=m2, compress_dtype="float32",
                    **amp)
            return cls(model, gpt_loss, opt, mesh=m2, wire_dtype=wire,
                       ring=ring, **amp)
        reset_fa(fa)
        out = zero_dp2_run(models2, init2, make, ids_t, ring_quant,
                           LoopbackWorld)
        if fa_counts(fa)[:3] != (2 * ZERO_DP2_STEPS * ZERO_DP2_LAYERS,) * 3:
            fail(f"zero dp=2 {kind} {wire}: flash launches "
                 f"{fa_counts(fa)[:3]}")
        return out

    class FaultyGather(ShardedUpdateTrainStep):
        """A planted fault: the all-gather decodes int8 with int4's qmax."""

        def _all_gather(self, shard):
            return super()._all_gather(shard) * (127.0 / 7.0)

    class StalledGather(ShardedUpdateTrainStep):
        """A planted fault: the all-gather leaves the parameters as they
        were, so no step changes them."""

        def __call__(self, *inputs):
            keep = [p.detach().clone() for p in self.model.parameters()]
            loss = super().__call__(*inputs)
            with torch.no_grad():
                for p, k in zip(self.model.parameters(), keep):
                    p.copy_(k)
            return loss

    class MisseatedRing(ShardedUpdateTrainStep):
        """A planted fault: the ring reduce-scatter's hops add the local
        block one seat off."""

        def _reduce_scatter(self, gflat):
            return misseated_reduce_scatter(gflat, self.mesh,
                                            chunk=self.chunk,
                                            wire=self.wire) / self.dp

    rep = dp2("replicated")
    rep_again = dp2("replicated")
    repro2 = max(params_diff(a["snaps"][-1], b["snaps"][-1])
                 for a, b in zip(rep, rep_again))
    z32 = dp2("zero")
    d32 = max(params_diff(a["snaps"][-1], b["snaps"][-1])
              for a, b in zip(z32, rep))
    d32 = max([d32] + [abs(x - y) for a, b in zip(z32, rep)
                       for x, y in zip(a["losses"], b["losses"])])
    log(f"zero dp=2 f32: losses {z32[0]['losses']}; against the replicated "
        f"step max |difference| {d32:.3g} (replicated against itself "
        f"{repro2:.3g})")
    if d32 > repro2:
        fail("zero dp=2 f32 differs from the replicated step by more than "
             "the replicated step from itself")
    del rep, rep_again
    dp2_rows = {"f32": {"losses": z32[0]["losses"],
                        "opt_state_bytes_per_replica": z32[0]["opt_bytes"],
                        "wire_bytes": z32[0]["wire_bytes"]}}
    drift, plain_d = {}, {}
    # (key, wire, ring, #9 launches a step per rank, step class)
    runs = (("int8", "int8", False, 2 * ZERO_LEAVES, ShardedUpdateTrainStep),
            ("int4-ring", "int4", True, 3 * ZERO_LEAVES,
             ShardedUpdateTrainStep),
            ("int8-stalled", "int8", False, 2 * ZERO_LEAVES, StalledGather),
            ("int4-ring-misseated", "int4", True, 3 * ZERO_LEAVES,
             MisseatedRing),
            ("int8-qmax", "int8", False, 2 * ZERO_LEAVES, FaultyGather))
    faults = [key for key, *_, cls in runs
              if cls is not ShardedUpdateTrainStep]
    for key, wire, ring, per, cls in runs:
        ranks = dp2("zero", wire, ring, cls)
        want = [per * (i + 1) for i in range(ZERO_DP2_STEPS)]
        for r, got in enumerate(ranks):
            if got["quant"] != want:
                fail(f"zero dp=2 {key}: rank {r} launched ring_quant "
                     f"{got['quant']} != {want}")
        for i in range(ZERO_DP2_STEPS):
            if params_diff(ranks[0]["snaps"][i], ranks[1]["snaps"][i]) != 0:
                fail(f"zero dp=2 {key}: the replicas differ after step {i}")
        drift[key] = max(abs(x - y) for x, y in zip(ranks[0]["losses"],
                                                    z32[0]["losses"]))
        log(f"zero dp=2 {key}: losses {ranks[0]['losses']}, ring_quant "
            f"launches per rank {[got['quant'] for got in ranks]}, replicas "
            f"bitwise equal after every step, max |loss - f32 loss| "
            f"{drift[key]:.4g} (limit {TOL_ZERO_LOSS:g})")
        if key in faults:
            del ranks
            continue
        # the same steps with the plain codec in place of #9: the same bits
        plain_rq = ring_quant.ring_quant_rows
        ring_quant.ring_quant_rows = ring_quant.ring_quant_rows_reference
        try:
            plain = dp2("zero", wire, ring)
        finally:
            ring_quant.ring_quant_rows = plain_rq
        plain_d[key] = max(
            max(params_diff(a["snaps"][i], b["snaps"][i])
                for i in range(ZERO_DP2_STEPS)) for a, b in zip(ranks, plain))
        plain_d[key] = max([plain_d[key]] + [
            abs(x - y) for a, b in zip(ranks, plain)
            for x, y in zip(a["losses"], b["losses"])])
        log(f"zero dp=2 {key}: through #9 against through the plain codec, "
            f"max |difference| of losses and parameters {plain_d[key]:.3g} "
            f"(replicated against itself {repro2:.3g}); plain codec "
            f"launches {[got['quant'][-1] for got in plain]}")
        if plain_d[key] > repro2 or any(got["quant"][-1] for got in plain):
            fail(f"zero dp=2 {key} through #9 differs from the plain "
                 "codec's steps")
        zero_launch[key] = zero_launch.get(key, 0) + sum(
            got["quant"][-1] for got in ranks)
        dp2_rows[key] = {"losses": ranks[0]["losses"],
                         "wire_bytes": ranks[0]["wire_bytes"]}
        del ranks, plain
    if drift["int8"] > TOL_ZERO_LOSS or drift["int4-ring"] > TOL_ZERO_LOSS:
        fail("zero dp=2: a quantized wire's loss left the f32 loss by more "
             f"than {TOL_ZERO_LOSS}")
    for key in faults:
        if not drift[key] > TOL_ZERO_LOSS:
            fail(f"zero dp=2: the planted fault {key} reads "
                 f"{drift[key]:.4g}, not above the limit {TOL_ZERO_LOSS}")
    del models2, init2, z32
    torch.cuda.empty_cache()

    return {"grows": grows, "quant_err": quant_err, "launches": zero_launch,
            "summary": {
                "zero_world1": zero_runs, "zero_trainstep_repro": repro,
                "zero_int8_kernel_vs_plain_codec": d_plain,
                "zero_wire_bytes_per_leg_dp2": wire_bytes_dp2,
                "zero_dp2_simulated": dp2_rows,
                "zero_dp2_f32_vs_replicated": d32,
                "zero_dp2_replicated_repro": repro2,
                "zero_dp2_loss_drift": drift,
                "zero_dp2_kernel_vs_plain_codec": plain_d,
                "zero_ring_envelope_excess": ring_ex}}


def dcgan_models(nn, ngf, ndf, device="cuda"):
    """DCGAN (Radford, Metz and Chintala, arXiv:1511.06434, section 3 and
    figure 1) of public layers (the JAX package has no GAN class, so
    neither has the port): G projects z (B, 100, 1, 1) to 4 x 4 by
    Conv2DTranspose(100, 8 ngf, 4, 1, 0), then Conv2DTranspose(k4, s2, p1)
    to 4 ngf, 2 ngf, ngf and 3 channels, BatchNorm2D + ReLU after each but
    the last, Tanh after it; D mirrors it with Conv2D(k4, s2, p1) 3 -> ndf
    -> 8 ndf, LeakyReLU(0.2) after each and BatchNorm2D after all but the
    first, then Conv2D(8 ndf, 1, 4).  Weights N(0, 0.02) by ParamAttr;
    no bias where a BatchNorm follows.  tests/torch_dcgan_common.py builds
    the same in both packages."""
    def attr():
        return nn.ParamAttr(initializer=nn.initializer.Normal(0.0, 0.02))
    widths = [8 * ngf, 4 * ngf, 2 * ngf, ngf]
    g = [nn.Conv2DTranspose(DCGAN_Z, widths[0], 4, 1, 0, weight_attr=attr(),
                            bias_attr=False, device=device),
         nn.BatchNorm2D(widths[0], device=device), nn.ReLU()]
    for cin, cout in zip(widths, widths[1:]):
        g += [nn.Conv2DTranspose(cin, cout, 4, 2, 1, weight_attr=attr(),
                                 bias_attr=False, device=device),
              nn.BatchNorm2D(cout, device=device), nn.ReLU()]
    g += [nn.Conv2DTranspose(ngf, 3, 4, 2, 1, weight_attr=attr(),
                             device=device), nn.Tanh()]
    widths = [ndf, 2 * ndf, 4 * ndf, 8 * ndf]
    d = [nn.Conv2D(3, ndf, 4, 2, 1, weight_attr=attr(), device=device),
         nn.LeakyReLU(0.2)]
    for cin, cout in zip(widths, widths[1:]):
        d += [nn.Conv2D(cin, cout, 4, 2, 1, weight_attr=attr(),
                        bias_attr=False, device=device),
              nn.BatchNorm2D(cout, device=device), nn.LeakyReLU(0.2)]
    d.append(nn.Conv2D(8 * ndf, 1, 4, weight_attr=attr(), device=device))
    return nn.Sequential(*g), nn.Sequential(*d)


def seq2seq_model(nn, vocab, d_model, nhead, layers, ffn, max_len,
                  dropout=0.0, device="cuda", generator=None):
    """The seq2seq composition of public layers (the JAX package has no
    seq2seq model class, so neither has the port): source and target
    Embeddings, learned position Embeddings, the Transformer, a Linear
    head.  tests/torch_seq2seq_common.py builds the same in both
    packages."""
    import torch

    class Seq2Seq(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(vocab, d_model, device=device)
            self.tgt_emb = nn.Embedding(vocab, d_model, device=device)
            self.src_pos = nn.Embedding(max_len, d_model, device=device)
            self.tgt_pos = nn.Embedding(max_len, d_model, device=device)
            self.transformer = nn.Transformer(
                d_model, nhead, layers, layers, ffn, dropout, device=device,
                generator=generator)
            self.head = nn.Linear(d_model, vocab, device=device)

        def embed(self, emb, pos, ids):
            return emb(ids) + pos(torch.arange(ids.shape[1],
                                               device=ids.device))

        def forward(self, src, tgt, src_mask, tgt_mask, memory_mask):
            out = self.transformer(
                self.embed(self.src_emb, self.src_pos, src),
                self.embed(self.tgt_emb, self.tgt_pos, tgt), src_mask,
                tgt_mask, memory_mask)
            return self.head(out)

    return Seq2Seq()


def seq2seq_loss(model, src, tgt, label, src_mask, tgt_mask, memory_mask):
    """Label-smoothed soft-label cross-entropy over the target tokens, the
    padding weighted out, as the translation example's criterion."""
    from paddle_tpu_torch.nn import functional as F
    logits = model(src, tgt, src_mask, tgt_mask, memory_mask)
    soft = F.label_smooth(F.one_hot(label, logits.shape[-1]),
                          epsilon=S2S_EPS)
    ce = F.cross_entropy(logits, soft, soft_label=True, reduction="none")
    w = (label != S2S_PAD).to(ce.dtype)
    return (ce * w).sum() / w.sum()


def seq2seq_batch(vocab, b, s_src, s_tgt, seed=0):
    """(src, tgt, label, src bias) as numpy from default_rng(seed): source
    lengths in [S/2, S], target lengths in [T/2, T], S2S_PAD past a
    length; tgt is the label shifted right behind S2S_START; the bias
    (B, 1, 1, S) f32 is 0 on real keys and -1e9 on padding."""
    import numpy as np
    rng = np.random.default_rng(seed)
    src_len = rng.integers(s_src // 2, s_src + 1, (b,))
    tgt_len = rng.integers(s_tgt // 2, s_tgt + 1, (b,))
    src = rng.integers(3, vocab, (b, s_src))
    label = rng.integers(3, vocab, (b, s_tgt))
    src = np.where(np.arange(s_src) < src_len[:, None], src, S2S_PAD)
    label = np.where(np.arange(s_tgt) < tgt_len[:, None], label, S2S_PAD)
    tgt = np.concatenate([np.full((b, 1), S2S_START), label[:, :-1]], 1)
    bias = np.where(np.arange(s_src) < src_len[:, None], 0.0, -1e9)
    return (src.astype(np.int64), tgt.astype(np.int64),
            label.astype(np.int64), bias[:, None, None, :].astype(np.float32))


def seq2seq_inputs(nn, arrays, device):
    """TrainStep's inputs from seq2seq_batch's arrays: src, tgt, label,
    the src bias, the causal (T, T) target mask and the memory mask (the
    src bias again), on ``device``."""
    import torch
    src, tgt, label, bias = (torch.as_tensor(a, device=device)
                             for a in arrays)
    causal = nn.Transformer.generate_square_subsequent_mask(tgt.shape[1],
                                                            device=device)
    return [src, tgt, label, bias, causal, bias]


def beam_cell(nn, model, memory, memory_mask, beam):
    """The beam-search cell over the composition's decoder: (token
    embedding, (caches, positions)) -> (decoder output, new states).  The
    position of each (B * beam) row is in the states, so the beam gather
    reorders it; memory and its mask are tiled once."""
    mem = nn.BeamSearchDecoder.tile_beam_merge_with_batch(memory, beam)
    mask = nn.BeamSearchDecoder.tile_beam_merge_with_batch(memory_mask, beam)

    def cell(inputs, states):
        caches, pos = states
        x = (inputs + model.tgt_pos(pos))[:, None]
        out, caches = model.transformer.decoder(x, mem, None, mask, caches)
        return out[:, 0], (caches, pos + 1)
    return cell


def beam_request(nn, fa, model, src, bias, beam, max_step):
    """One serving request through the entry points: the encoder once, then
    BeamSearchDecoder + dynamic_decode over the decoder's caches.  Returns
    (memory, predicted (B, T, W), final state, lengths, the steps'
    {token, parent}, the flash counts after the encoder)."""
    import torch

    class Recording(nn.BeamSearchDecoder):
        def finalize(self, outputs, final_state, sequence_lengths):
            self.outputs = outputs
            return super().finalize(outputs, final_state, sequence_lengths)

    memory = model.transformer.encoder(
        model.embed(model.src_emb, model.src_pos, src), bias)
    enc_counts = fa_counts(fa)
    dec = Recording(beam_cell(nn, model, memory, bias, beam), S2S_START,
                    S2S_END, beam, embedding_fn=model.tgt_emb,
                    output_fn=model.head)
    pos = torch.zeros(src.shape[0], dtype=torch.int64, device=src.device)
    pred, state, lengths = nn.dynamic_decode(
        dec, (model.transformer.decoder.gen_cache(memory), pos),
        max_step_num=max_step, return_length=True)
    return memory, pred, state, lengths, dec.outputs, enc_counts


def beam_invariants(nn, model, memory, bias, pred, state, lengths, outputs,
                    tol_abs, tol_rel):
    """Fails unless each request's final beam log-probs fall across the
    beams, the best beam's log-prob is the teacher-forced rescoring of its
    tokens (to its length) by the same model within tol_abs + tol_rel *
    |log-prob|, and gather_tree's sequences follow the recorded parents.
    Returns the rescoring's largest absolute and relative errors."""
    import numpy as np
    import torch
    lp = state.log_probs
    if not bool((lp[:, :-1] >= lp[:, 1:]).all()):
        fail(f"beam log-probs do not fall across the beams: {lp.tolist()}")
    best = pred[:, :, 0]
    b, t = best.shape
    tgt = torch.cat([torch.full((b, 1), S2S_START, device=best.device),
                     best[:, :-1]], 1)
    out = model.transformer.decoder(
        model.embed(model.tgt_emb, model.tgt_pos, tgt), memory,
        nn.Transformer.generate_square_subsequent_mask(t,
                                                       device=best.device),
        bias)
    step_lp = torch.log_softmax(model.head(out).float(), -1).gather(
        2, best[..., None])[..., 0]
    live = torch.arange(t, device=best.device)[None, :] < lengths[:, :1]
    got = (step_lp * live).sum(1)
    err = (got - lp[:, 0]).abs()
    if not bool((err <= tol_abs + tol_rel * lp[:, 0].abs()).all()):
        fail(f"the best beam's log-prob {lp[:, 0].tolist()} is not its "
             f"teacher-forced rescoring {got.tolist()}")
    tok = np.stack([o["token"].cpu().numpy() for o in outputs])
    par = np.stack([o["parent"].cpu().numpy() for o in outputs])
    want = np.empty_like(tok)
    for bi in range(tok.shape[1]):
        for w in range(tok.shape[2]):
            p = w
            for s in range(tok.shape[0] - 1, -1, -1):
                want[s, bi, w] = tok[s, bi, p]
                p = par[s, bi, p]
    if not np.array_equal(want.transpose(1, 0, 2), pred.cpu().numpy()):
        fail("gather_tree's sequences do not follow the recorded parents")
    return float(err.max()), float((err / lp[:, 0].abs()).max())


def masked_times(g, fa, F, b, h, sq, sk, d, mask, sdpa_mask, pairs,
                 bias_bytes, causal=False):
    """The bf16 flash kernels #1 (forward), #2 (dq) and #3 (dk/dv) at (b,
    h, sq, sk, d) with ``mask`` (a Mask or None) on random inputs: each
    kernel's ms (CUDA events), SDPA's forward and backward ms on the same
    work (with ``sdpa_mask``), and each kernel's bound from the (query,
    key) ``pairs`` the work takes and the mask's ``bias_bytes``."""
    import torch
    bh, sc = b * h, d ** -0.5
    qt, kt, vt, dot = (rand(g, (bh, n, d), torch.bfloat16)
                       for n in (sq, sk, sk, sq))
    ot, lse = fa._launch(qt, kt, vt, sc, causal, mask)
    delta = fa._delta(dot, ot)
    q4, do4 = (t.view(b, h, sq, d) for t in (qt, dot))
    k4, v4 = (t.view(b, h, sk, d) for t in (kt, vt))
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    out_l = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=sdpa_mask,
                                           is_causal=causal, scale=sc)
    r = {"fwd_ms": cuda_ms(lambda: fa._launch(qt, kt, vt, sc, causal,
                                              mask)),
         "dq_ms": cuda_ms(lambda: fa._launch_dq(qt, kt, vt, dot, lse, delta,
                                                sc, causal, mask)),
         "dkv_ms": cuda_ms(lambda: fa._launch_dkv(qt, kt, vt, dot, lse,
                                                  delta, sc, causal, mask)),
         "sdpa_fwd_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
             q4, k4, v4, attn_mask=sdpa_mask, is_causal=causal, scale=sc)),
         "sdpa_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
             out_l, (ql, kl, vl), do4, retain_graph=True))}
    prod = 2 * d * pairs                             # one product
    tq, tk, rb = bh * sq * d * 2, bh * sk * d * 2, bh * sq * 4
    # forward: 2 products, reads q, k, v (and the bias), writes out and
    # lse; dq: 3, reads q, k, v, do, lse, delta, writes dq; dk/dv: 4,
    # writes dk and dv
    for name, n_prod, nbytes in (("fwd", 2, 2 * tq + 2 * tk + rb),
                                 ("dq", 3, 3 * tq + 2 * tk + 2 * rb),
                                 ("dkv", 4, 2 * tq + 4 * tk + 2 * rb)):
        r[name + "_bound_ms"], r[name + "_bound_by"] = bound(
            n_prod * prod, nbytes + bias_bytes, PEAK_BF16_FLOPS)
    return r


def seq2seq_kernel_checks(g, fa, bias):
    """#1-#3 against their plain versions, beside the planted faults, at
    the three mask shapes of the seq2seq path on seq2seq-train's batch
    (``bias``: its (B, 1, 1, S) f32 source bias): cross-attention (128
    queries, 256 keys) under the bias row, the decoder's self-attention
    under the full (1, 1, 128, 128) causal bias, the encoder at S = 256
    under the bias row; each bias in bf16 (TrainStep's O2 cast) and the
    rows in f32 too (serving).  Returns (out, dq, dk/dv) max errors."""
    import torch
    from paddle_tpu_torch.nn import Transformer
    bf16 = torch.bfloat16
    causal = Transformer.generate_square_subsequent_mask(S2S_TGT).view(
        1, 1, S2S_TGT, S2S_TGT)
    errs = []
    for s, m in (((S2S_TGT, S2S_SRC), bias), ((S2S_TGT, S2S_TGT), causal),
                 ((S2S_SRC, S2S_SRC), bias)):
        for dt in ((bf16, torch.float32) if m is bias else (bf16,)):
            errs.append(check_masked(
                g, fa, (S2S_B, S2S_HEADS, s, 64, bf16, None, None, False,
                        False),
                fa.Mask(m.to(dt).contiguous(), None, None, S2S_HEADS),
                dbias=False)[:3])
    return tuple(max(e[i] for e in errs) for i in range(3))


def seq2seq_small(nn, fa, TrainStep, Adam):
    """seq2seq-small: the small composition (2 + 2 layers, d_model 128, 2
    heads of 64, V = 512, S = 256 / 128), f32, card against CPU: logits,
    the loss and every gradient; one TrainStep with Adam(1e-3), the
    parameters where the CPU's gradient is above GRAD_FLOOR (elsewhere each
    move within Adam's bound); then 20 card steps of one batch at the same
    constant rate, whose loss must fall; then a beam decode (4 beams, 16
    steps) whose invariants hold at TOL_RESCORE_F32.  Returns the
    errors."""
    import copy

    import torch
    torch.manual_seed(0)
    cpu = seq2seq_model(nn, max_len=S2S_SRC, device="cpu", **S2S_SMALL)
    gpu = copy.deepcopy(cpu).to("cuda")
    arrays = seq2seq_batch(S2S_SMALL["vocab"], 2, S2S_SRC, S2S_TGT, seed=3)
    ins = {m: seq2seq_inputs(nn, arrays, d) for m, d in ((gpu, "cuda"),
                                                         (cpu, "cpu"))}
    before = fa_counts(fa)
    with torch.no_grad():
        logits = [m(*ins[m][:2], *ins[m][3:]).cpu() for m in (gpu, cpu)]
    launched = [a - b for a, b in zip(fa_counts(fa), before)]
    if launched != [0, 0, 0, 6, 0, 0, 0]:
        fail(f"the small seq2seq forward launched {launched}, not 6 masked "
             "forward kernels (2 encoder, 2 decoder, 2 cross)")
    err = {"logits": float((logits[0] - logits[1]).abs().max())}
    losses = []
    for m in (gpu, cpu):
        loss = seq2seq_loss(m, *ins[m])
        loss.backward()
        losses.append(float(loss.detach()))
    err["loss"] = abs(losses[0] - losses[1])
    gp = dict(gpu.named_parameters())
    err["grads"] = max(float((gp[n].grad.cpu() - p.grad).abs().max())
                       for n, p in cpu.named_parameters())
    floor = {n: p.grad.abs() > GRAD_FLOOR for n, p in cpu.named_parameters()}
    old = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    for m in (gpu, cpu):
        m.zero_grad()
        TrainStep(m, seq2seq_loss, Adam(learning_rate=1e-3))(*ins[m])
    err["params"] = 0.0
    for n, p in cpu.named_parameters():
        got = gp[n].detach().cpu()
        err["params"] = max(err["params"], float(torch.where(
            floor[n], got - p.detach(), 0.0).abs().max()))
        for moved in (got - old[n], p.detach() - old[n]):
            if float(moved.abs().max()) > 1e-3 * 1.01:
                fail(f"one Adam(1e-3) step moved {n} past Adam's bound")
    step = TrainStep(gpu, seq2seq_loss, Adam(learning_rate=1e-3))
    falls = [float(step(*ins[gpu])) for _ in range(S2S_SMALL_STEPS)]
    gpu.eval()
    with torch.no_grad():
        src, bias = ins[gpu][0], ins[gpu][3]
        memory, pred, state, lengths, outs, _ = beam_request(
            nn, fa, gpu, src, bias, BEAM, S2S_SMALL_BEAM_STEPS)
        err["rescore"] = beam_invariants(nn, gpu, memory, bias, pred, state,
                                         lengths, outs, TOL_RESCORE_F32,
                                         0.0)[0]
    return err, falls, lengths.tolist()


def seq2seq_train(nn, fa, TrainStep, Adam, power):
    """seq2seq-train: Transformer-base at full width and depth, f32
    masters, TrainStep with AMP O2 bf16, Adam(beta2=0.98, epsilon=1e-9)
    under NoamDecay(512, 4000, learning_rate=2.0), dropout 0.1 from an
    explicit generator, label smoothing 0.1, B=32, sources of 256 and
    targets of 128; S2S_WARMUP then S2S_STEPS timed steps.  Fails unless
    each step launches 18 of each masked flash kernel (#1-#3: 6 encoder,
    6 decoder self, 6 cross) and nothing else, the losses are finite and
    the first near ln V, and every parameter moved.  Returns (the model,
    the phase's row, its launches by counter)."""
    import torch

    from paddle_tpu_torch.optimizer import lr
    gen = torch.Generator(device="cuda").manual_seed(7)
    torch.manual_seed(0)
    model = seq2seq_model(nn, S2S_V, S2S_D, S2S_HEADS, S2S_LAYERS, S2S_FFN,
                          S2S_SRC, dropout=0.1, generator=gen)
    sched = lr.NoamDecay(S2S_D, 4000, learning_rate=2.0)
    step = TrainStep(model, seq2seq_loss,
                     Adam(learning_rate=sched, beta2=0.98, epsilon=1e-9),
                     amp_level="O2", amp_dtype="bfloat16")
    arrays = seq2seq_batch(S2S_V, S2S_B, S2S_SRC, S2S_TGT)
    inputs = seq2seq_inputs(nn, arrays, "cuda")
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    reset_fa(fa)
    losses, counts = [], []
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for i in range(S2S_WARMUP + S2S_STEPS):
        if i == S2S_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            e0.record()
        losses.append(step(*inputs))
        sched.step()
        counts.append(fa_counts(fa))
    e1.record()
    torch.cuda.synchronize()
    step_ms = e0.elapsed_time(e1) / S2S_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    launches = dict(zip(FA_COUNTERS, counts[-1]))
    real = int((arrays[2] != S2S_PAD).sum())
    row = {"step_ms": step_ms,
           "tokens_per_s": S2S_B * S2S_TGT / step_ms * 1e3,
           "real_target_tokens": real,
           "real_tokens_per_s": real / step_ms * 1e3, "peak_bytes": peak,
           "losses": losses, "lr_last": sched()}
    log(f"seq2seq-train: Transformer-base ({S2S_LAYERS} + {S2S_LAYERS} "
        f"layers, d_model {S2S_D}, {S2S_HEADS} heads, FFN {S2S_FFN}, V "
        f"{S2S_V} + {S2S_V}), O2 bf16, Adam(0.98, 1e-9) under "
        f"NoamDecay(512, 4000, 2.0), dropout 0.1, label smoothing 0.1, "
        f"B={S2S_B} x {S2S_SRC} -> {S2S_TGT} ({real} real target tokens): "
        f"step {step_ms:.4f} ms (CUDA events, mean of {S2S_STEPS} after "
        f"{S2S_WARMUP} warm-ups), {row['tokens_per_s']:.1f} target "
        f"tokens/s, peak {peak} bytes; losses {losses} (ln V = "
        f"{math.log(S2S_V):.4f}); launches after each step {counts} "
        f"[{power}]")
    per_step = (0, 0, 0, 3 * S2S_LAYERS, 3 * S2S_LAYERS, 3 * S2S_LAYERS, 0)
    want = [tuple(k * (i + 1) for k in per_step) for i in range(len(counts))]
    if counts != want:
        fail(f"seq2seq-train launch counts {counts} != {per_step} a step")
    if not all(math.isfinite(x) for x in losses):
        fail("a seq2seq-train loss is not finite")
    if abs(losses[0] - math.log(S2S_V)) > 1.0:
        fail("the first seq2seq-train loss is not near ln V")
    still = [n for n, p in model.named_parameters()
             if not bool((p.detach() != old[n]).any())]
    if still:
        fail(f"seq2seq-train left parameters where they were: {still}")
    del old, step, inputs
    torch.cuda.empty_cache()
    return model, row, launches


def seq2seq_serve(nn, fa, model, power):
    """seq2seq-serve: the trained model's weights cast to bf16, eval mode,
    SERVE_REQUESTS requests of SERVE_B sources of S2S_SRC (lengths in
    [S/2, S], an f32 bias row) under inference_mode, beam BEAM, at most
    MAX_STEP steps, through beam_request.  Fails unless each request's
    encoder launches S2S_LAYERS masked forward kernels and nothing else,
    its decode steps none, and beam_invariants hold at TOL_RESCORE_BF16.
    Returns (the phase's row, its launches by counter)."""
    import torch
    model.to(torch.bfloat16).eval()
    lat, steps, errs, total = [], [], [], [0] * len(FA_COUNTERS)
    for r in range(SERVE_REQUESTS):
        src, _, _, bias = (torch.as_tensor(a, device="cuda") for a in
                           seq2seq_batch(S2S_V, SERVE_B, S2S_SRC, S2S_TGT,
                                         seed=10 + r))
        reset_fa(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            memory, pred, state, lengths, outs, enc = beam_request(
                nn, fa, model, src, bias, BEAM, MAX_STEP)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            after = fa_counts(fa)
            steps.append(pred.shape[1])
            if enc != (0, 0, 0, S2S_LAYERS, 0, 0, 0) or after != enc:
                fail(f"seq2seq-serve request {r}: launches {enc} after the "
                     f"encoder and {after} after the decode, not "
                     f"{S2S_LAYERS} masked forward kernels and then none")
            total = [a + b for a, b in zip(total, after)]
            errs.append(beam_invariants(nn, model, memory, bias, pred, state,
                                        lengths, outs, 0.0,
                                        TOL_RESCORE_BF16))
    row = {"latency_ms": lat, "steps": steps,
           "tokens_per_s": [SERVE_B * n / ms * 1e3
                            for n, ms in zip(steps, lat)],
           "beam_step_ms": [ms / n for n, ms in zip(steps, lat)],
           "rescore_abs_rel_err": errs}
    log(f"seq2seq-serve: the model in bf16, {SERVE_REQUESTS} requests of "
        f"{SERVE_B} x {S2S_SRC} (f32 bias rows), beam {BEAM}, at most "
        f"{MAX_STEP} steps: latency ms {lat}, steps {steps}, generated "
        f"tokens/s (one sequence a source) {row['tokens_per_s']}; beam "
        f"invariants hold, best-beam rescoring |err| and |err| / |log-prob| "
        f"{errs} (tol {TOL_RESCORE_BF16:g} relative) [{power}]")
    return row, dict(zip(FA_COUNTERS, total))


def rnn_phase(nn, power):
    """rnn: LSTM and GRU (RNN_LAYERS layers, bidirect, hidden RNN_H over
    inputs of RNN_IN), B=RNN_B, T=RNN_T, sequence lengths in [T/2, T], f32,
    card against CPU: outputs and final states by max |difference|, every
    gradient of sum(out * w) / B by max |difference| / max |CPU's|, both
    within TOL_F32; and the forward + backward's ms on the card."""
    import copy

    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    x = rng.standard_normal((RNN_B, RNN_T, RNN_IN)).astype(np.float32)
    lens = rng.integers(RNN_T // 2, RNN_T + 1, (RNN_B,))
    w = rng.standard_normal((RNN_B, RNN_T, 2 * RNN_H)).astype(np.float32)
    rows = {}
    for kind in ("LSTM", "GRU"):
        torch.manual_seed(0)
        cpu = getattr(nn, kind)(RNN_IN, RNN_H, RNN_LAYERS,
                                direction="bidirect", device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")

        def run(m):
            dev = next(iter(m.parameters())).device
            xt = torch.as_tensor(x, device=dev).requires_grad_()
            out, st = m(xt, sequence_length=torch.as_tensor(lens,
                                                            device=dev))
            loss = (out * torch.as_tensor(w, device=dev)).sum() / RNN_B
            grads = torch.autograd.grad(loss, [xt, *m.parameters()])
            st = st if isinstance(st, tuple) else (st,)
            return [out, *st], grads

        (fo_g, gr_g), (fo_c, gr_c) = run(gpu), run(cpu)
        e_out = max(float((a.detach().cpu() - b.detach()).abs().max())
                    for a, b in zip(fo_g, fo_c))
        e_grad = max(float((a.cpu() - b).abs().max() / b.abs().max())
                     for a, b in zip(gr_g, gr_c))
        ms = cuda_ms(lambda: run(gpu), reps=3, warmup=1)
        rows[kind] = {"fwd_bwd_ms": ms, "out_state_err": e_out,
                      "grad_scaled_err": e_grad}
        log(f"rnn: {kind} ({RNN_LAYERS} layers, bidirect, hidden {RNN_H}, "
            f"input {RNN_IN}), B={RNN_B}, T={RNN_T} with sequence_length, "
            f"f32, card vs CPU: outputs and states max_abs_err={e_out:.3g}, "
            f"gradients max_err / max |CPU's|={e_grad:.3g} (tol "
            f"{TOL_F32:g}); forward + backward {ms:.4f} ms (CUDA events) "
            f"[{power}]")
        if e_out > TOL_F32 or e_grad > TOL_F32:
            fail(f"{kind} on the card disagrees with the CPU")
        del cpu, gpu
    return rows


def gpt_param_shapes(cfg):
    """The shapes of GPT's 16 stacked parameter tensors (models/gpt.py
    ``init_params``), in ``_PARAM_ORDER``."""
    L, H, F_, V, S_ = (cfg.num_layers, cfg.hidden_size, cfg.ffn_size,
                       cfg.vocab_size, cfg.max_seq_len)
    return [(V, H), (S_, H), (L, H), (L, H), (L, H, 3 * H), (L, 3 * H),
            (L, H, H), (L, H), (L, H), (L, H), (L, H, F_), (L, F_),
            (L, F_, H), (L, H), (H,), (H,)]


def adam_bf16_inputs(g, shapes, offsets=None):
    """bf16 (p, g, m, v) at ``shapes``, each tensor ``offsets[i]`` elements
    into its own buffer (0: 16-byte aligned); moments as after a few
    steps."""
    import torch
    offsets = offsets or [0] * len(shapes)

    def t(scale, square=False):
        out = []
        for s, off in zip(shapes, offsets):
            n = math.prod(s)
            x = torch.randn(n + off, generator=g, device="cuda") * scale
            x = x.square() if square else x
            out.append(x.bfloat16()[off:].view(s))
        return out
    return t(0.02), t(1e-3), t(1e-4), t(1e-4, square=True)


def adam_bf16_rates(AdamW, n, steps=3):
    """lr_t ``steps`` steps in, widened to f32: as the optimizer forms it
    under decorate O2, from bf16 beta pows (``Adam._pows_and_rate``, the
    reference's rounding: beta2 = 0.999 is 1.0 in bf16, so the rate is 0),
    and from f32 beta pows (as TrainStep's f32 state forms it)."""
    import torch
    opt = AdamW(LR_PEAK)
    rates = []
    for dt in (torch.bfloat16, torch.float32):
        b1p = b2p = torch.ones(n, dtype=dt, device="cuda")
        for _ in range(steps):
            b1p, b2p, lr_t = opt._pows_and_rate(b1p, b2p, LR_PEAK)
        rates.append(lr_t.float())
    return rates


def adam_bf16_faults(p, gr, m, v, lr_t, lr_bf16, wd_lr, b1, b2, eps):
    """The bf16 update with one fault planted, as (name, (p', m', v')): a
    store that truncates instead of rounding; p' stepped from the rounded
    bf16 m' and v' instead of the f32 values; the rate formed from f32 beta
    pows where the optimizer forms it from bf16 ones (``lr_t`` is the f32
    one, ``lr_bf16`` the optimizer's)."""
    import torch
    from paddle_tpu_torch.ops.cuda.fused_adam import one_minus
    c1, c2 = one_minus(b1), one_minus(b2)

    def run(lr, trunc=False, step_rounded=False):
        out = ([], [], [])
        for i, (pi, gi, mi, vi) in enumerate(zip(p, gr, m, v)):
            g32, p32 = gi.float(), pi.float()
            m2 = b1 * mi.float() + c1 * g32
            v2 = b2 * vi.float() + c2 * g32 * g32
            ms, vs = ((m2.bfloat16().float(), v2.bfloat16().float())
                      if step_rounded else (m2, v2))
            np_ = p32 - lr[i] * ms / (torch.sqrt(vs) + eps) - wd_lr * p32
            for o, x in zip(out, (np_, m2, v2)):
                o.append((x.view(torch.int32) & -65536).view(
                    torch.float32).bfloat16() if trunc else x.bfloat16())
        return out
    return [("truncating store", lr_t, run(lr_t, trunc=True)),
            ("step from the rounded m', v'", lr_t,
             run(lr_t, step_rounded=True)),
            ("lr_t from f32 beta pows", lr_bf16, run(lr_t))]


def check_adam_bf16(g, fused_adam, AdamW, shapes, faults=True):
    """#8's bf16 instantiation against its plain version at ``shapes``
    with lr_t from f32 beta pows (a rate above 0): bitwise, and two calls
    bitwise equal; each planted fault unequal to the kernel (the last one
    against the kernel at the optimizer's own rate).  Returns (elements,
    the inputs for timing)."""
    import torch
    p, gr, m, v = adam_bf16_inputs(g, shapes)
    lr_bf16, lr_t = adam_bf16_rates(AdamW, len(shapes))
    wd_lr = torch.tensor(LR_PEAK * 0.01, device="cuda")
    consts = (0.9, 0.999, 1e-8)
    args = (lr_t, wd_lr) + consts
    got = fused_adam._launch(p, gr, m, v, *args)
    again = fused_adam._launch(p, gr, m, v, *args)
    want = fused_adam.fused_adam_reference(p, gr, m, v, *args)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in p)
    for what, a_l, b_l in (("plain version", got, want),
                           ("second call", got, again)):
        for a, b in zip(sum(a_l, []), sum(b_l, [])):
            if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
                fail(f"fused_adam bf16 is not bitwise its {what} at "
                     f"shapes {shapes}")
    del again, want
    if faults:
        for name, rate, out in adam_bf16_faults(p, gr, m, v, lr_t, lr_bf16,
                                                wd_lr, *consts):
            kern = got if rate is lr_t else fused_adam._launch(
                p, gr, m, v, rate, wd_lr, *consts)
            diff = sum(int((a.view(torch.int16) != b.view(torch.int16))
                           .sum()) for a, b in zip(sum(out, []),
                                                   sum(kern, [])))
            log(f"check fused_adam bf16 planted fault '{name}': "
                f"{diff} of {3 * n} stored values differ")
            if diff == 0:
                fail(f"the planted fault '{name}' went unseen")
            del out, kern
    return n, (p, gr, m, v, args)


def mlp_pair(tnn, ParamAttr, treg):
    """The eager-small MLP on the card and on the CPU with the same
    weights: fc1's weight at half the rate with an L1 regulariser, fc2's
    weight with an L2 regulariser, fc1's bias frozen."""
    import torch

    class MLP(torch.nn.Module):
        def __init__(self, device):
            super().__init__()
            self.fc1 = tnn.Linear(
                MLP_IN, MLP_HID, ParamAttr("fc1.w", learning_rate=0.5,
                                           regularizer=treg.L1Decay(1e-3)),
                ParamAttr("fc1.b", trainable=False), device=device)
            self.fc2 = tnn.Linear(
                MLP_HID, MLP_OUT,
                ParamAttr("fc2.w", regularizer=treg.L2Decay(1e-2)),
                ParamAttr("fc2.b"), device=device)

        def forward(self, x):
            return self.fc2(torch.tanh(self.fc1(x)))
    gpu, cpu = MLP("cuda"), MLP("cpu")
    with torch.no_grad():
        for a, b in zip(gpu.parameters(), cpu.parameters()):
            b.copy_(a.cpu())
    return gpu, cpu


def eager_optimizers(topt, treg):
    """The ten optimizers of the eager loop, each as a factory of its
    parameter list (some with the options only the eager step honours)."""
    return {
        "SGD": lambda P: topt.SGD(0.1, parameters=P, weight_decay=1e-3),
        "Momentum": lambda P: topt.Momentum(0.1, 0.9, parameters=P,
                                            use_nesterov=True),
        "LarsMomentum": lambda P: topt.LarsMomentum(
            0.1, 0.9, parameters=P, exclude_from_weight_decay=["fc2"]),
        "Adam": lambda P: topt.Adam(0.01, parameters=P, use_fused=True,
                                    weight_decay=treg.L2Decay(1e-3)),
        "AdamW": lambda P: topt.AdamW(
            0.01, parameters=P, weight_decay=0.1,
            apply_decay_param_fun=lambda n: n.endswith(".w")),
        "Adamax": lambda P: topt.Adamax(0.01, parameters=P),
        "Adagrad": lambda P: topt.Adagrad(0.1, parameters=P,
                                          initial_accumulator_value=0.1),
        "Adadelta": lambda P: topt.Adadelta(1.0, parameters=P),
        "RMSProp": lambda P: topt.RMSProp(0.01, rho=0.9, momentum=0.9,
                                          centered=True, parameters=P),
        "Lamb": lambda P: topt.Lamb(
            0.01, parameters=P,
            exclude_from_weight_decay_fn=lambda p: p.name.endswith(".b")),
    }


def mlp_train(model, opt, batches):
    import torch
    dev = next(iter(model.parameters())).device
    for x, y in batches:
        loss = ((model(torch.from_numpy(x).to(dev))
                 - torch.from_numpy(y).to(dev)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()


def eager_small_optimizers(tnn, topt, treg, ParamAttr):
    """Every optimizer's eager step on the card against the CPU (f32,
    MLP_STEPS steps of the ParamAttr MLP): the largest parameter and state
    error over its scale; then state_dict -> set_state_dict resumes
    bitwise on the card.  Returns {optimizer: error}."""
    import numpy as np
    import torch
    rng = np.random.default_rng(7)
    batches = [(rng.standard_normal((MLP_B, MLP_IN)).astype(np.float32),
                rng.standard_normal((MLP_B, MLP_OUT)).astype(np.float32))
               for _ in range(MLP_STEPS + 1)]
    errs = {}
    for name, make in eager_optimizers(topt, treg).items():
        gpu, cpu = mlp_pair(tnn, ParamAttr, treg)
        frozen = gpu.fc1.bias.detach().clone()
        og, oc = make(list(gpu.parameters())), make(list(cpu.parameters()))
        mlp_train(gpu, og, batches[:MLP_STEPS])
        mlp_train(cpu, oc, batches[:MLP_STEPS])
        err = 0.0
        sg, sc = og.state_dict(), oc.state_dict()
        if sorted(sg) != sorted(sc):
            fail(f"{name}: state_dict keys differ, card {sorted(sg)} CPU "
                 f"{sorted(sc)}")
        pairs = [(a.detach(), b.detach()) for a, b in
                 zip(gpu.parameters(), cpu.parameters())] + [
            (sg[k], sc[k]) for k in sc if isinstance(sc[k], torch.Tensor)]
        for a, b in pairs:
            err = max(err, float((a.cpu() - b).abs().max())
                      / (float(b.abs().max()) + 0.1))
        if not torch.equal(gpu.fc1.bias, frozen):
            fail(f"{name} moved the frozen bias")
        errs[name] = err
        # resume: a fresh model and optimizer from the state after the
        # steps take the next step bitwise as the running ones do
        again, _ = mlp_pair(tnn, ParamAttr, treg)
        with torch.no_grad():
            for a, b in zip(again.parameters(), gpu.parameters()):
                a.copy_(b)
        oa = make(list(again.parameters()))
        oa.set_state_dict(og.state_dict())
        mlp_train(gpu, og, batches[MLP_STEPS:])
        mlp_train(again, oa, batches[MLP_STEPS:])
        for a, b in zip(again.parameters(), gpu.parameters()):
            if not torch.equal(a, b):
                fail(f"{name}: set_state_dict did not resume bitwise")
    return errs


def amp_dtypes(trace, names):
    """{op: sorted set of its input-dtype tuples} of an amp.trace_ops
    record, for the ops named."""
    out = {}
    for n, ds in trace:
        if n in names:
            out.setdefault(n, set()).add(
                tuple(str(d).replace("torch.", "") for d in ds))
    return {n: sorted(v) for n, v in out.items()}


def eager_small_amp(amp, F, topt, treg, GPT, gpt_loss, gpt_tiny,
                    mobilenet_v2):
    """A small GPT and MobileNetV2 (scale 0.25, 64x64) under auto_cast O1
    and O2 on the card: each op's input dtypes by amp.trace_ops against
    the lists' rule, and one scaled step each.  Returns {case: dtypes}."""
    import numpy as np
    import torch
    bf, f32 = ("bfloat16",), ("float32",)
    rng = np.random.default_rng(8)
    ids = torch.as_tensor(rng.integers(0, 256, (2, 256)), device="cuda")
    x = torch.as_tensor(rng.standard_normal((4, 3, 64, 64)),
                        dtype=torch.float32, device="cuda")
    y = torch.as_tensor(rng.integers(0, 10, (4,)), device="cuda")
    seen = {}
    for level in ("O1", "O2"):
        model = GPT(gpt_tiny(num_layers=2, hidden_size=128, num_heads=2,
                             max_seq_len=256, remat=False), device="cuda")
        opt = topt.AdamW(1e-3, parameters=list(model.parameters()),
                         use_fused=True)
        if level == "O2":
            amp.decorate(model, opt, level="O2")
        scaler = amp.GradScaler()
        p0 = [p.detach().clone() for p in model.parameters()]
        with amp.auto_cast(level=level), amp.trace_ops() as trace:
            loss = gpt_loss(model, ids, ids)
        scaler.minimize(opt, scaler.scale(loss))
        got = amp_dtypes(trace, ("gpt_forward", "gpt_loss"))
        dt = bf if level == "O2" else f32
        if got != {"gpt_forward": [dt * 16], "gpt_loss": [dt]} or \
                loss.dtype != torch.float32:
            fail(f"small GPT under {level}: op input dtypes {got}")
        # O2 reproduces the reference's bf16 beta pows: beta2 = 0.999 is
        # 1.0 in bf16, lr_t is 0 and the decay is below half an ulp, so no
        # parameter moves (see eager-gpt); O1's f32 state moves them all
        moved = [bool((a != b).any()) for a, b in
                 zip(model.parameters(), p0)]
        if moved != [level == "O1"] * len(moved) or opt._global_step != 1:
            fail(f"small GPT under {level}: parameters moved {moved} by the "
                 "scaled step")
        seen[f"gpt_{level}"] = got
        m = mobilenet_v2(scale=0.25, num_classes=10)
        opt = topt.RMSProp(0.01, rho=0.9, momentum=0.9,
                           parameters=list(m.parameters()),
                           weight_decay=treg.L2Decay(MB_WD))
        scaler = amp.GradScaler()
        with amp.auto_cast(level=level), amp.trace_ops() as trace:
            loss = F.cross_entropy(m(x), y).mean()
        scaler.minimize(opt, scaler.scale(loss))
        got = amp_dtypes(trace, ("conv2d", "batch_norm", "relu6", "linear",
                                 "cross_entropy"))
        want = {"conv2d": [bf * 2], "batch_norm": [f32 * 5],
                "relu6": [bf if level == "O2" else f32],
                "linear": [bf * 3], "cross_entropy": [f32]}
        if got != want or not bool(torch.isfinite(loss)) or \
                opt._global_step != 1:
            fail(f"small MobileNetV2 under {level}: op input dtypes {got}, "
                 f"want {want}; loss {float(loss)}")
        seen[f"mobilenet_v2_{level}"] = got
    return seen


def device_busy_ms(fn):
    """(device ms, wall ms) of one fn() traced by torch.profiler: the sum
    of its kernels' times and the wall time to a synchronize, which the
    profiler lengthens (the idle share divides the busy time by the
    untraced step's, as tools/profile_gpt.py does)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    if busy <= 0:
        fail("the profiler saw no device time")
    return busy, wall


def eager_loop(step, steps):
    """``steps`` calls of step() (each returns its loss, on the card):
    (losses, CUDA-event ms a step, host ms a step until step() returns)."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    losses, host = [], 0.0
    e0.record()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        host += time.perf_counter() - t0
    e1.record()
    torch.cuda.synchronize()
    return ([float(x) for x in losses], e0.elapsed_time(e1) / steps,
            host * 1e3 / steps)


def eager_gpt(GPT, cfg, gpt_loss, amp, AdamW, fa, fused_adam, ids_t,
              power):
    """GPT-2 345M trained by the dygraph loop under decorate O2 with
    AdamW(use_fused=True), GradScaler and auto_cast O2: EAGER_WARM +
    EAGER_TIMED steps on one batch, the launch counters set to 0 just
    before and read after each step.  Returns the row of numbers and the
    launch counts."""
    import torch
    L = cfg.num_layers
    model = GPT(cfg, device="cuda")
    opt = AdamW(EAGER_LR, parameters=list(model.parameters()),
                use_fused=True)
    model, opt = amp.decorate(model, opt, level="O2")
    scaler = amp.GradScaler()
    p0 = [p.detach().clone() for p in model.parameters()]
    b, s = ids_t.shape

    def step():
        with amp.auto_cast(level="O2"):
            loss = gpt_loss(model, ids_t, ids_t)
        scaler.minimize(opt, scaler.scale(loss))
        opt.clear_grad()
        return loss.detach()
    counters = ((fa, "launches"), (fa, "launches_dq"), (fa, "launches_dkv"),
                (fused_adam, "launches_bf16"), (fused_adam, "launches"))
    for mod, attr in counters:
        setattr(mod, attr, 0)
    counts, losses = [], []
    for _ in range(EAGER_WARM):
        losses.append(float(step()))
        counts.append(tuple(getattr(m, a) for m, a in counters))
    torch.cuda.reset_peak_memory_stats()
    timed, step_ms, host_ms = [], 0.0, 0.0
    for _ in range(EAGER_TIMED):
        l_, ms, h = eager_loop(step, 1)
        timed += l_
        step_ms += ms / EAGER_TIMED
        host_ms += h / EAGER_TIMED
        counts.append(tuple(getattr(m, a) for m, a in counters))
    launches = dict(zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv", "fused_adam_bf16",
                         "fused_adam"), counts[-1]))
    peak = torch.cuda.max_memory_allocated()
    losses += timed
    busy, wall = device_busy_ms(step)
    log(f"eager-gpt: decorate(O2), AdamW({EAGER_LR:g}, use_fused=True), "
        f"GradScaler(), auto_cast(O2), B={b}, S={s}: losses {losses}")
    log(f"eager-gpt: launch counts after each step (flash fwd, dq, dk/dv, "
        f"fused_adam bf16, fused_adam f32): {counts}")
    steps = EAGER_WARM + EAGER_TIMED
    want = [(L * (i + 1),) * 3 + (i + 1, 0) for i in range(steps)]
    if counts != want:
        fail(f"eager-gpt launch counts {counts} != {L} forward, dq and dk/dv "
             "and one bf16 fused_adam launch a step")
    if not all(math.isfinite(x) for x in losses):
        fail(f"eager-gpt: a loss is not finite: {losses}")
    if scaler._scale != 2.0 ** 15 or opt._global_step != steps + 1:
        fail(f"eager-gpt: the scaler skipped a step (scale {scaler._scale},"
             f" {opt._global_step} optimizer steps of {steps + 1})")
    # the reference's semantics, reproduced: in bf16 beta2 = 0.999 is 1.0,
    # so beta2^t stays 1 and lr_t = lr sqrt(1 - beta2^t) / (1 - beta1^t) is
    # 0; the decoupled decay (lr coeff p, 1e-6 of p) is below half a bf16
    # ulp.  No parameter moves, the loss of the one batch repeats bitwise,
    # and the moments move
    b1 = b2 = torch.ones((), dtype=torch.bfloat16, device="cuda")
    for _ in range(steps + 1):
        b1, b2, _ = opt._pows_and_rate(b1, b2, EAGER_LR)
    for (n, p), q in zip(model.named_parameters(), p0):
        st = opt._state_for(p)
        if p.dtype != torch.bfloat16 or st["moment1"].dtype != p.dtype:
            fail(f"eager-gpt: {n} or its moments are not bf16")
        if float(st["beta2_pow"]) != 1.0 or not torch.equal(
                st["beta1_pow"], b1.reshape(st["beta1_pow"].shape)):
            fail(f"eager-gpt: {n}'s beta pows are not the bf16 chain")
        if not torch.equal(p, q) or not bool(st["moment1"].any()):
            fail(f"eager-gpt: {n} moved, or its moment did not")
    if len(set(losses)) != 1:
        fail(f"eager-gpt: the losses of one batch with unmoved parameters "
             f"differ: {losses}")
    log("eager-gpt: as in the reference, bf16 beta2 = 1.0 makes lr_t = 0: "
        "every parameter bf16 and bitwise where it started, the moments "
        "updated, the loss repeating bitwise")
    # the same loop with beta2 = 0.99 (0.98828125 in bf16): lr_t is above
    # 0, so the loss falls and every tensor holding an entry below 2^-5
    # moves (its half ulp, 6.1e-5 or less, is below the first step's move
    # of about lr_t = 1.1e-4; a layer norm's unit weights stay)
    del opt
    opt = AdamW(EAGER_LR, beta2=0.99, parameters=list(model.parameters()),
                use_fused=True)
    fused_adam.launches_bf16 = 0
    moving = [float(step()) for _ in range(EAGER_MOVING)]
    log(f"eager-gpt: the loop with AdamW({EAGER_LR:g}, beta2=0.99, "
        f"use_fused=True): losses {moving}")
    if fused_adam.launches_bf16 != EAGER_MOVING or not all(
            math.isfinite(x) for x in moving) or \
            not moving[-1] < moving[0]:
        fail(f"eager-gpt with beta2 = 0.99: losses {moving} do not fall, or "
             f"{fused_adam.launches_bf16} bf16 fused_adam launches in "
             f"{EAGER_MOVING} steps")
    for (n, p), q in zip(model.named_parameters(), p0):
        if bool((q.abs() < 2.0 ** -5).any()) and torch.equal(p, q):
            fail(f"eager-gpt with beta2 = 0.99: {n} did not move")
    row = {"eager_gpt_step_ms": step_ms,
           "eager_gpt_tokens_per_s": b * s / step_ms * 1e3,
           "eager_gpt_peak_bytes": peak,
           "eager_gpt_host_ms_until_step_returns": host_ms,
           "eager_gpt_device_busy_ms": busy,
           "eager_gpt_traced_wall_ms": wall,
           "eager_gpt_device_idle_share": max(0.0, 1.0 - busy / step_ms),
           "eager_gpt_losses": losses,
           "eager_gpt_beta2_0.99_losses": moving}
    log(f"eager-gpt: step {step_ms:.3f} ms (CUDA events, mean of "
        f"{EAGER_TIMED} after {EAGER_WARM} warm-ups), "
        f"{row['eager_gpt_tokens_per_s']:.1f} training tokens/s, "
        f"max_memory_allocated {peak} bytes, host {host_ms:.3f} ms until "
        f"the step returns, device busy {busy:.3f} ms in a traced step "
        f"({wall:.3f} ms with the profiler; idle share 1 - busy / step "
        f"{row['eager_gpt_device_idle_share']:.3f}); {power}")
    del model, opt, p0
    torch.cuda.empty_cache()
    return row, launches


def eager_vision(mobilenet_v1, mobilenet_v2, vgg16, amp, F, topt, treg,
                 power):
    """MobileNetV2 at full width trained by the dygraph loop under O1 with
    RMSProp and L2Decay as Sandler et al. train it, B=MB_BATCH at
    MB_HW^2; then one eager step at 224^2, B=2, card against CPU (in f64
    and evaluation mode): Momentum for VGG-16 and MobileNetV1, the recipe
    for MobileNetV2; then MobileNetV2's O1 loss, card against CPU.
    Returns the row of numbers."""
    import numpy as np
    import torch
    model = mobilenet_v2(scale=1.0, num_classes=1000)
    opt = topt.RMSProp(MB_LR, rho=0.9, momentum=0.9,
                       parameters=list(model.parameters()),
                       weight_decay=treg.L2Decay(MB_WD))
    scaler = amp.GradScaler()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((MB_BATCH, 3, MB_HW, MB_HW)),
                        dtype=torch.float32, device="cuda")
    y = torch.as_tensor(rng.integers(0, 1000, (MB_BATCH,)), device="cuda")

    def step():
        with amp.auto_cast(level="O1"):
            loss = F.cross_entropy(model(x), y).mean()
        scaler.minimize(opt, scaler.scale(loss))
        opt.clear_grad()
        return loss.detach()
    with amp.trace_ops() as trace:
        losses = [float(step())]
    got = amp_dtypes(trace, ("conv2d", "batch_norm", "relu6", "linear",
                             "cross_entropy"))
    want = {"conv2d": [("bfloat16",) * 2], "batch_norm": [("float32",) * 5],
            "relu6": [("float32",)], "linear": [("bfloat16",) * 3],
            "cross_entropy": [("float32",)]}
    log(f"eager-vision: MobileNetV2 O1 op input dtypes {got}")
    if got != want:
        fail(f"eager-vision: op input dtypes {got}, want {want}")
    for _ in range(EAGER_WARM - 1):
        losses.append(float(step()))
    torch.cuda.reset_peak_memory_stats()
    timed, step_ms, host_ms = eager_loop(step, EAGER_TIMED)
    peak = torch.cuda.max_memory_allocated()
    losses += timed
    busy, wall = device_busy_ms(step)
    log(f"eager-vision: MobileNetV2 (1.0, 1000 classes), auto_cast(O1), "
        f"RMSProp({MB_LR:g}, rho=0.9, momentum=0.9, weight_decay="
        f"L2Decay({MB_WD:g})), GradScaler(), B={MB_BATCH} at {MB_HW}x"
        f"{MB_HW}: losses {losses}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"eager-vision: a loss is not finite: {losses}")
    if scaler._scale != 2.0 ** 15 or opt._global_step != len(losses) + 1:
        fail(f"eager-vision: the scaler skipped a step (scale "
             f"{scaler._scale}, {opt._global_step} optimizer steps)")
    row = {"eager_vision_step_ms": step_ms,
           "eager_vision_samples_per_s": MB_BATCH / step_ms * 1e3,
           "eager_vision_peak_bytes": peak,
           "eager_vision_host_ms_until_step_returns": host_ms,
           "eager_vision_device_busy_ms": busy,
           "eager_vision_traced_wall_ms": wall,
           "eager_vision_device_idle_share": max(0.0, 1.0 - busy / step_ms),
           "eager_vision_losses": losses,
           "eager_vision_loss_fell": losses[-1] < losses[0]}
    log(f"eager-vision: step {step_ms:.3f} ms (CUDA events, mean of "
        f"{EAGER_TIMED} after {EAGER_WARM} warm-ups), "
        f"{row['eager_vision_samples_per_s']:.1f} samples/s, "
        f"max_memory_allocated {peak} bytes, host {host_ms:.3f} ms until "
        f"the step returns, device busy {busy:.3f} ms in a traced step "
        f"({wall:.3f} ms with the profiler; idle share 1 - busy / step "
        f"{row['eager_vision_device_idle_share']:.3f}); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {power}")
    del model, opt, x
    torch.cuda.empty_cache()
    row.update(eager_vision_vs_cpu(mobilenet_v1, mobilenet_v2, vgg16, amp, F,
                                   topt, treg))
    torch.cuda.empty_cache()
    return row


def eager_vision_vs_cpu(mobilenet_v1, mobilenet_v2, vgg16, amp, F, topt,
                        treg):
    """eager-vision's steps card against CPU at 224^2, B=2.  Returns the
    row of numbers."""
    import numpy as np
    import torch
    row = {}
    # one eager step, card against CPU, in f64 and evaluation mode: VGG-16
    # and MobileNetV1 by Momentum, MobileNetV2 by the recipe above (RMSProp,
    # L2Decay, GradScaler.minimize) without auto_cast, whose bf16
    # convolutions round differently on each device (logged below).  In
    # f32 a ReLU or max-pool input within rounding of its kink takes the
    # other side on one device and moves the gradients behind it (VGG-16's
    # f32 moves differ by 2.7e-2 of a move, H100 against the CPU); in
    # training mode MobileNetV1's batch norms take f32 statistics (the
    # reference's rule, in f64 too) over 98 values a channel at the last
    # stage, summed in another order on each device (8.9e-2 of a move)
    r = np.random.default_rng(1)
    xs = torch.from_numpy(r.standard_normal((2, 3, 224, 224)))
    ys = torch.from_numpy(r.integers(0, 1000, (2,)))

    def momentum(m):
        topt.Momentum(1e-2, 0.9, parameters=list(m.parameters())).minimize(
            F.cross_entropy(m(xs.to(dev)), ys.to(dev)).mean())

    def recipe(m):
        opt = topt.RMSProp(MB_LR, rho=0.9, momentum=0.9,
                           parameters=list(m.parameters()),
                           weight_decay=treg.L2Decay(MB_WD))
        sc = amp.GradScaler()
        sc.minimize(opt, sc.scale(F.cross_entropy(m(xs.to(dev)),
                                                  ys.to(dev)).mean()))
        if sc._scale != 2.0 ** 15 or opt._global_step != 1:
            fail("eager-vision: the recipe's f64 step was skipped")
    for name, make, step, what in (
            ("vgg16", vgg16, momentum, "Momentum(1e-2, 0.9)"),
            ("mobilenet_v1", mobilenet_v1, momentum, "Momentum(1e-2, 0.9)"),
            ("mobilenet_v2", mobilenet_v2, recipe,
             f"RMSProp({MB_LR:g}, rho=0.9, momentum=0.9, weight_decay="
             f"L2Decay({MB_WD:g})) by GradScaler().minimize")):
        gpu, cpu = eval_pair(make, xs, torch.float64)
        old = {n: p.detach().clone() for n, p in cpu.named_parameters()}
        for m in (gpu, cpu):
            dev = next(iter(m.parameters())).device
            step(m)
        err = moves_err(gpu, cpu, old, f"{name}'s eager step")
        log(f"eager-vision: {name} one f64 {what} step in evaluation "
            f"mode, B=2 at 224x224, card vs CPU: parameter moves "
            f"max_err/move={err:.3g} (tol {TOL_MOVE:g})")
        if err > TOL_MOVE:
            fail(f"{name}'s eager step on the card disagrees with the CPU")
        row[f"eager_vision_{name}_move_err"] = err
        del gpu, cpu, old
    # MobileNetV2's first O1 forward and backward, card against CPU (f32
    # parameters, bf16 convolutions and linear): the loss within bf16
    # rounding; the gradients' difference is logged, not held, as the
    # rounding of the 52 bf16 convolutions dominates some of them
    gpu, cpu = eval_pair(mobilenet_v2, xs, torch.float32)
    out = []
    for m in (gpu, cpu):
        dev = next(iter(m.parameters())).device
        with amp.auto_cast(level="O1"):
            loss = F.cross_entropy(m(xs.to(dev).float()), ys.to(dev)).mean()
        loss.backward()
        out.append((float(loss.detach()), torch.cat([p.grad.flatten().cpu()
                                            for p in m.parameters()])))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out
    g_err = float((g_gpu - g_cpu).norm() / g_cpu.norm())
    log(f"eager-vision: mobilenet_v2 O1 forward and backward in evaluation "
        f"mode, B=2 at 224x224, card vs CPU: loss {l_gpu:.6f} vs "
        f"{l_cpu:.6f} (tol {TOL_LOSS_BF16_REL:g} relative), gradients "
        f"|g_card - g_cpu| / |g_cpu| = {g_err:.3g} (not held)")
    if not abs(l_gpu - l_cpu) <= TOL_LOSS_BF16_REL * abs(l_cpu):
        fail("eager-vision: MobileNetV2's O1 loss on the card disagrees "
             "with the CPU")
    row["eager_vision_mobilenet_v2_o1_loss_err"] = abs(l_gpu - l_cpu)
    row["eager_vision_mobilenet_v2_o1_grad_rel_diff"] = g_err
    return row


def dcgan_batch(b, device, seed=0):
    """Seeded noise images in [-1, 1] (the point is the path, not the
    data), z ~ N(0, 1), and the real / fake labels."""
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    real = r.uniform(-1, 1, (b, 3, 64, 64)).astype(np.float32)
    z = r.standard_normal((b, DCGAN_Z, 1, 1)).astype(np.float32)
    ones = torch.ones(b, 1, 1, 1, device=device)
    return (torch.as_tensor(real, device=device),
            torch.as_tensor(z, device=device), ones, torch.zeros_like(ones))


def dcgan_iteration(g, d, opt_g, opt_d, loss_fn, real, z, ones, zeros,
                    between=None):
    """One iteration of the eager loop: fake = G(z); a D step on real and
    (detached) fake; a G step on D's verdict on the same fake.
    ``between(stage)`` runs after each backward ("d", "g"), before its
    step.  Returns the two losses (tensors)."""
    fake = g(z)
    d_loss = loss_fn(d(real), ones) + loss_fn(d(fake.detach()), zeros)
    d_loss.backward()
    if between:
        between("d")
    opt_d.step()
    opt_d.clear_grad()
    g_loss = loss_fn(d(fake), ones)
    g_loss.backward()
    if between:
        between("g")
    opt_g.step()
    opt_g.clear_grad()
    opt_d.clear_grad()
    return d_loss, g_loss


def dcgan_layers_f32(nn, cpu, gpu, real, z):
    """Each convolution and transposed convolution of the small pair alone
    in f32, card against CPU, on the input that the CPU pair's training
    forward gives it (its running stats restored after): the output and
    the gradients of its input and parameters for a seeded upstream
    gradient, max scaled_err.  The gradients are cleared after."""
    import torch
    gen = torch.Generator().manual_seed(0)
    stats = [b.clone() for m in cpu for b in m.buffers()]

    def alone(layer, x, dy):
        x = x.detach().clone().requires_grad_()
        out = layer(x)
        out.backward(dy)
        ps = [p for p in layer.parameters() if p.grad is not None]
        res = [out.detach().cpu(), x.grad.cpu()] + [p.grad.cpu() for p in ps]
        for p in ps:
            p.grad = None
        return res
    err = 0.0
    for i, x in ((0, z), (1, real)):
        for theirs, card in zip(cpu[i].children(), gpu[i].children()):
            if isinstance(theirs, (nn.Conv2D, nn.Conv2DTranspose)):
                dy = torch.randn(theirs(x).shape, generator=gen)
                want = alone(theirs, x, dy)
                got = alone(card, x.cuda(), dy.cuda())
                err = max([err] + [scaled_err(a, b)
                                   for a, b in zip(got, want)])
            with torch.no_grad():
                x = theirs(x)
    with torch.no_grad():
        for b, old in zip((b for m in cpu for b in m.buffers()), stats):
            b.copy_(old)
    return err


def dcgan_card_vs_cpu(nn, cpu, gpu, adam, loss_fn, batch_size):
    """The small (G, D) pair, card against CPU from one state.  In f32:
    each convolution alone (dcgan_layers_f32), then a training-mode
    forward (G on z, D on the real and the fake batch): both losses and
    every running stat, by scaled_err.  The training-mode gradients of a
    DCGAN are not comparable across two implementations in f32: batch
    norm over B=8 and the ReLU kinks move them by up to 0.2 of their scale
    between two roundings of the same model (tools/f32_gradient_spread.py
    --model dcgan, f32 against f64, 12 seeds: 3 past 1e-3 on the CPU, 2 on
    an H100; in evaluation mode 0 and 1), and at this seed the CPU's own
    f32 gradients sit 0.128 from f64 on 1 or 4 threads, 7.5e-6 on 8 (its
    --threads), so a reading depends on the machine's CPU count.  So, as
    phase 13 does, one iteration is then held in f64 and evaluation mode,
    on the running stats the CPU's forward left: both losses, every
    gradient, and one Adam step of each network, the card's optimizers
    stepping from the CPU's gradients.  Returns the readings by name:
    "layers_f32", "train_f32", "loss_f64" (max relative), "grad_f64" (max
    scaled_err), "moves_f64" (max |got - want| / (max |want| + lr)),
    "none" (the names whose gradient was None on both: such a parameter,
    spectral norm's vectors, is compared by its move, which must be none)
    and "losses" (the CPU's f64 losses)."""
    import torch
    real, z, ones, zeros = dcgan_batch(batch_size, "cpu")
    r = {"layers_f32": dcgan_layers_f32(nn, cpu, gpu, real, z)}
    outs = {}
    with torch.no_grad():
        for name, (gm, dm) in (("cpu", cpu), ("cuda", gpu)):
            fake = gm(z.to(name))
            out_r, out_f = dm(real.to(name)), dm(fake)
            outs[name] = [
                loss_fn(out_r, ones.to(name)) + loss_fn(out_f, zeros.to(name)),
                loss_fn(out_f, ones.to(name))] + [
                b for m in (gm, dm) for b in m.buffers()]
        r["train_f32"] = max(scaled_err(a.cpu(), b) for a, b in
                             zip(outs["cuda"], outs["cpu"]))
        # the running stats that forward left, the CPU's on both
        for mine, theirs in zip(outs["cuda"][2:], outs["cpu"][2:]):
            mine.copy_(theirs)
    runs = {}
    for name, (gm, dm) in (("cpu", cpu), ("cuda", gpu)):
        for m in (gm, dm):
            m.double()
            m.eval()
        before = {f"{w}.{n}": p.detach().clone()
                  for w, m in (("g", gm), ("d", dm))
                  for n, p in m.named_parameters()}
        grads = {}

        def between(stage, gm=gm, dm=dm, grads=grads, name=name):
            m = dm if stage == "d" else gm
            for n, p in m.named_parameters():
                key = f"{stage}.{n}"
                grads[key] = (None if p.grad is None
                              else p.grad.detach().clone())
                if name == "cuda" and p.grad is not None:
                    # step from the CPU's gradients
                    p.grad.copy_(runs["cpu"]["grads"][key])
        losses = dcgan_iteration(
            gm, dm, adam(gm), adam(dm), loss_fn,
            *(t.to(name, torch.float64) for t in (real, z, ones, zeros)),
            between=between)
        runs[name] = {
            "losses": [float(v.detach()) for v in losses], "grads": grads,
            "moves": {f"{w}.{n}": p.detach() - before[f"{w}.{n}"]
                      for w, m in (("g", gm), ("d", dm))
                      for n, p in m.named_parameters()}}
    got, want = runs["cuda"], runs["cpu"]
    r["loss_f64"] = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                            want["losses"]))
    r["none"] = sorted(k for k, v in want["grads"].items() if v is None)
    if r["none"] != sorted(k for k, v in got["grads"].items() if v is None):
        fail("the card and the CPU disagree on which parameters have no "
             "gradient")
    r["grad_f64"] = max(scaled_err(got["grads"][k].cpu(), v)
                        for k, v in want["grads"].items() if v is not None)
    r["moves_f64"] = max(float((got["moves"][k].cpu() - v).abs().max()
                               / (v.abs().max() + DCGAN_LR))
                         for k, v in want["moves"].items())
    r["losses"] = want["losses"]
    return r


DCGAN_CHECKS = ("layers_f32", "train_f32", "loss_f64", "grad_f64",
                "moves_f64")


def dcgan_check_line(r):
    """The readings of dcgan_card_vs_cpu, for a log line."""
    return ", ".join(f"{k} {r[k]:.3g}" for k in DCGAN_CHECKS)


def dcgan_timed(gm, dm, opt_g, opt_d, loss_fn, what, power, still=()):
    """DCGAN_WARM warm-ups and DCGAN_ITERS timed iterations at B=DCGAN_B:
    (ms an iteration, peak bytes, (D, G) losses of each iteration); the
    losses finite, every parameter moved but those named in ``still``
    ("g.<name>" / "d.<name>"), which must not move."""
    import torch
    p0 = {f"{w}.{n}": p.detach().clone() for w, m in (("g", gm), ("d", dm))
          for n, p in m.named_parameters()}
    batch = dcgan_batch(DCGAN_B, "cuda")
    torch.cuda.reset_peak_memory_stats()
    losses = [dcgan_iteration(gm, dm, opt_g, opt_d, loss_fn, *batch)
              for _ in range(DCGAN_WARM)]
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(DCGAN_ITERS):
        losses.append(dcgan_iteration(gm, dm, opt_g, opt_d, loss_fn,
                                      *batch))
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / DCGAN_ITERS
    peak = torch.cuda.max_memory_allocated()
    losses = [[float(v.detach()) for v in pair] for pair in losses]
    n_g = sum(p.numel() for p in gm.parameters())
    n_d = sum(p.numel() for p in dm.parameters())
    log(f"{what}: ngf = ndf = {DCGAN_WIDTH} (G {n_g}, D {n_d} parameters), "
        f"B={DCGAN_B} at 64x64, f32, Adam({DCGAN_LR}, beta1=0.5) each, "
        f"{DCGAN_WARM} warm-ups then {DCGAN_ITERS} iterations: "
        f"{ms:.3f} ms an iteration (CUDA events), "
        f"{DCGAN_B / ms * 1e3:.1f} images/s, max_memory_allocated {peak} "
        f"bytes [{power}]; (D, G) losses first {losses[0]}, last "
        f"{losses[-1]}")
    if not all(math.isfinite(v) for pair in losses for v in pair):
        fail(f"a {what} loss is not finite")
    for w, m in (("g", gm), ("d", dm)):
        for n, p in m.named_parameters():
            key = f"{w}.{n}"
            if torch.equal(p.detach(), p0[key]) != (key in still):
                fail(f"{what} parameter {key} moved: "
                     f"{not torch.equal(p.detach(), p0[key])}")
    return ms, peak, losses


def dcgan_phase(nn, topt, power):
    """dcgan: the small model (ngf = ndf = DCGAN_SMALL, B=DCGAN_SMALL_B)
    card against CPU by dcgan_card_vs_cpu (f32 convolutions alone and a
    training-mode forward, then one f64 evaluation-mode iteration with an
    Adam step of each network from the CPU's gradients); then the published
    widths (ngf = ndf = 128) at B=DCGAN_B, 64 x 64, f32: DCGAN_WARM
    warm-ups and DCGAN_ITERS timed iterations, ms an iteration, images/s,
    peak bytes; losses finite and every parameter of both moved."""
    import copy

    import torch
    torch.manual_seed(0)
    cpu = dcgan_models(nn, DCGAN_SMALL, DCGAN_SMALL, device="cpu")
    gpu = copy.deepcopy(cpu)
    for m in gpu:
        m.to("cuda")
    bce = nn.BCEWithLogitsLoss()

    def adam(m):
        return topt.Adam(learning_rate=DCGAN_LR, beta1=0.5,
                         parameters=m.parameters())
    r = dcgan_card_vs_cpu(nn, cpu, gpu, adam, bce, DCGAN_SMALL_B)
    log(f"dcgan small (ngf = ndf = {DCGAN_SMALL}, B={DCGAN_SMALL_B}, 64x64) "
        f"card vs CPU: f32 convolutions alone and training-mode forward, "
        f"then f64 evaluation-mode iteration (CPU losses {r['losses']}, "
        f"gradients, one Adam step of each from the CPU's gradients): "
        f"{dcgan_check_line(r)} (tol {TOL_F32:g})")
    if max(r[k] for k in DCGAN_CHECKS) > TOL_F32:
        fail(f"the small DCGAN on the card disagrees with the CPU: "
             f"{dcgan_check_line(r)} (tol {TOL_F32:g})")
    del cpu, gpu

    torch.manual_seed(0)
    gm, dm = dcgan_models(nn, DCGAN_WIDTH, DCGAN_WIDTH)
    ms, peak, losses = dcgan_timed(gm, dm, adam(gm), adam(dm), bce, "dcgan",
                                   power)
    del gm, dm
    torch.cuda.empty_cache()
    return {"dcgan_iteration_ms": ms, "dcgan_images_per_s":
            DCGAN_B / ms * 1e3, "dcgan_peak_bytes": peak,
            "dcgan_small_errs": [r[k] for k in DCGAN_CHECKS],
            "dcgan_first_last_losses": [losses[0], losses[-1]]}


def filefed_collate(imgs, labels):
    """bench.py's _filefed_collate: uint8 HWC images -> /255, the ImageNet
    mean and std, NCHW float32; int64 labels."""
    import numpy as np
    x = np.stack(imgs).astype(np.float32) / 255.0
    x = (x - np.asarray(FF_MEAN, np.float32)) / np.asarray(FF_STD,
                                                           np.float32)
    return (np.ascontiguousarray(x.transpose(0, 3, 1, 2)),
            np.asarray(labels, np.int64))


def transforms_resnet50(T, resnet50, TrainStep, Momentum, power):
    """transforms-resnet50: bench.py's file-fed ResNet-50 recipe without
    its ingest plane.  TF_IMAGES uint8 images of TF_HW x TF_HW x 3 from
    default_rng(0) go through Compose([RandomResizedCrop(224),
    RandomHorizontalFlip()]) drawing from random.Random(0), batch by batch
    on the host in the loop (no worker, no prefetch: the card waits while
    the host prepares), collated as _filefed_collate, moved to the card and
    fed to ResNet-50's TrainStep (O2 bf16, Momentum(0.1, 0.9)) at
    B=VISION_B: one warm-up, then TF_STEPS steps.  The host ms of the
    transforms and the collate a batch, the step ms, the share of the loop's
    wall spent on input; finite losses, every parameter moved, the first
    batch's transforms bitwise equal when run again from the same seed."""
    import random

    import numpy as np
    import torch
    r = np.random.default_rng(0)
    images = r.integers(0, 256, (TF_IMAGES, TF_HW, TF_HW, 3), dtype=np.uint8)
    labels = r.integers(0, 1000, TF_IMAGES)

    def pipeline(seed):
        g = random.Random(seed)
        return T.Compose([T.RandomResizedCrop(VISION_HW, generator=g),
                          T.RandomHorizontalFlip(generator=g)])
    aug = pipeline(0)
    model = resnet50(num_classes=1000)
    step = TrainStep(model, vision_loss, Momentum(learning_rate=0.1,
                                                  momentum=0.9),
                     amp_level="O2", amp_dtype="bfloat16")
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    used, rows = [], []
    for i in range(1 + TF_STEPS):
        lo = i * VISION_B
        t0 = time.perf_counter()
        crops = [aug(im) for im in images[lo:lo + VISION_B]]
        t1 = time.perf_counter()
        x, y = filefed_collate(crops, labels[lo:lo + VISION_B])
        t2 = time.perf_counter()
        xt = torch.as_tensor(x).to("cuda")
        yt = torch.as_tensor(y).to("cuda")
        t3 = time.perf_counter()
        loss = step(xt, yt)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        used.append(x)
        rows.append({"transforms_ms": (t1 - t0) * 1e3,
                     "collate_ms": (t2 - t1) * 1e3,
                     "to_card_ms": (t3 - t2) * 1e3,
                     "step_ms": (t4 - t3) * 1e3, "loss": float(loss)})
    timed = rows[1:]
    mean = {k: sum(r[k] for r in timed) / TF_STEPS for k in timed[0]
            if k != "loss"}
    wall = sum(mean.values())
    wait = (mean["transforms_ms"] + mean["collate_ms"]
            + mean["to_card_ms"]) / wall
    again = pipeline(0)
    same = np.array_equal(filefed_collate(
        [again(im) for im in images[:VISION_B]], labels[:VISION_B])[0],
        used[0])
    log(f"transforms-resnet50: {TF_IMAGES} uint8 images {TF_HW}x{TF_HW}x3, "
        f"RandomResizedCrop({VISION_HW}) + RandomHorizontalFlip from "
        f"random.Random(0), resize route {T.resize_route()}; B={VISION_B}, "
        f"resnet50 TrainStep O2 bf16, Momentum(0.1, 0.9), one warm-up then "
        f"{TF_STEPS} steps: host transforms {mean['transforms_ms']:.2f} ms, "
        f"collate {mean['collate_ms']:.2f} ms, to the card "
        f"{mean['to_card_ms']:.2f} ms a batch; step "
        f"{mean['step_ms']:.3f} ms (host clock to synchronize); input "
        f"{wait:.3f} of the loop's wall; "
        f"{VISION_B / wall * 1e3:.1f} samples/s end to end [{power}]; "
        f"losses {[r['loss'] for r in rows]}; the first batch's transforms "
        f"run again from the same seed bitwise equal: {same}")
    if not all(math.isfinite(r["loss"]) for r in rows):
        fail("a transforms-resnet50 loss is not finite")
    for n, p in model.named_parameters():
        if torch.equal(p.detach(), p0[n]):
            fail(f"transforms-resnet50 parameter {n} did not move")
    if not same:
        fail("the transforms are not bitwise repeatable from one seed")
    del model, step, p0, used
    torch.cuda.empty_cache()
    return {"transforms_resnet50_" + k: v for k, v in mean.items()} | {
        "transforms_resnet50_input_share": wait,
        "transforms_resnet50_samples_per_s": VISION_B / wall * 1e3,
        "transforms_resize_route": T.resize_route()}


def breadth_run(fn, inputs, w=None):
    """fn(*inputs): its outputs (detached), the gradients of sum(out[0] *
    w) over the floating inputs (None where out[0] does not reach one) and
    w, drawn from a seeded CPU generator when not given."""
    import torch
    ins = [t.requires_grad_() if t.is_floating_point() else t
           for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    if w is None:
        w = torch.randn(outs[0].shape,
                        generator=torch.Generator().manual_seed(1))
    grads = torch.autograd.grad((outs[0] * w).sum(),
                                [t for t in ins if t.requires_grad],
                                allow_unused=True)
    return [o.detach() for o in outs], grads, w


def breadth_cases(F):
    """nn-breadth's (name, shape, fn, inputs, gradient limit): each new
    functional at a shape its users run, inputs from default_rng(0) on the
    CPU."""
    import numpy as np
    import torch
    r = np.random.default_rng(0)

    def n(*shape):
        return torch.as_tensor(r.standard_normal(shape).astype(np.float32))

    def pool_unpool(x):
        out, mask = F.max_pool2d(x, 3, 2, 1, return_mask=True)
        return (F.max_unpool2d(out, mask, 3, 2, 1, output_size=[112, 112]),
                mask, out.detach())
    b, t, c, s = CTC_B, CTC_T, CTC_C, CTC_S
    lab_len = r.integers(1, s + 1, b)
    labels = np.zeros((b, s), np.int64)
    for i, ln in enumerate(lab_len):
        labels[i, :ln] = r.integers(1, c, ln)
    in_len = r.integers(t // 2, t + 1, b)
    k = CRF_TAGS
    crf = [n(CRF_B, CRF_T, k), n(k + 2, k),
           torch.as_tensor(r.integers(0, k, (CRF_B, CRF_T))),
           torch.as_tensor(r.integers(CRF_T // 2, CRF_T + 1, CRF_B))]
    up = dict(scale_factor=2, mode="bilinear")
    cases = [
        ("max_pool2d(3, 2, 1, return_mask) + max_unpool2d", "32x64x112x112"
         " ReLU'd", pool_unpool, [torch.relu(n(32, 64, 112, 112))]),
        ("interpolate bilinear x2 up", "8x256x64x64",
         lambda x: F.interpolate(x, **up), [n(8, 256, 64, 64)]),
        ("interpolate bilinear x2 down (antialiased)", "8x256x64x64",
         lambda x: F.interpolate(x, scale_factor=0.5, mode="bilinear"),
         [n(8, 256, 64, 64)]),
        ("interpolate bicubic x2 up", "8x256x64x64",
         lambda x: F.interpolate(x, scale_factor=2, mode="bicubic"),
         [n(8, 256, 64, 64)]),
        ("ctc_loss", f"{c} classes, B={b}, T={t}, labels up to {s}",
         lambda lg, lb, il, ll: F.ctc_loss(lg, lb, il, ll, reduction="none"),
         [n(t, b, c), torch.as_tensor(labels), torch.as_tensor(in_len),
          torch.as_tensor(lab_len)], TOL_CTC_GRAD),
        ("grid_sample", "8x64x56x56, grid 8x56x56x2",
         lambda x, g: F.grid_sample(x, g),
         [n(8, 64, 56, 56), torch.as_tensor(r.uniform(
             -1.1, 1.1, (8, 56, 56, 2)).astype(np.float32))]),
        ("linear_chain_crf", f"B={CRF_B}, T={CRF_T}, {k} tags",
         F.linear_chain_crf, crf),
        ("viterbi_decode", f"B={CRF_B}, T={CRF_T}, {k} tags",
         lambda em, tr, ln: F.viterbi_decode(em, tr, ln),
         [crf[0], crf[1], crf[3]]),
        ("unfold", "8x64x56x56, k3 p1",
         lambda x: F.unfold(x, 3, paddings=1), [n(8, 64, 56, 56)]),
        ("fold", "8x576x3136 -> 56x56, k3 p1",
         lambda x: F.fold(x, 56, 3, paddings=1), [n(8, 576, 56 * 56)]),
        ("pixel_shuffle", "8x256x56x56, r=2",
         lambda x: F.pixel_shuffle(x, 2), [n(8, 256, 56, 56)]),
    ]
    return [c if len(c) == 5 else c + (TOL_F32,) for c in cases]


def nn_breadth(F, power):
    """nn-breadth: each case of breadth_cases on the card against the CPU
    in f32 (values by scaled_err within TOL_BREADTH, gradients within the
    case's limit, every other output bitwise: the pool's mask and values,
    the Viterbi paths), then its forward + backward ms on the card."""
    import torch
    rows = {}
    for name, shape, fn, inputs, tol in breadth_cases(F):
        cpu_out, cpu_grads, w = breadth_run(fn, inputs)
        ins = [t.detach().to("cuda") for t in inputs]
        wg = w.to("cuda")
        outs, grads, _ = breadth_run(fn, ins, wg)
        # the CPU's results go to the card, where the measures are taken
        val = scaled_err(outs[0], cpu_out[0].to("cuda"))
        exact = all(torch.equal(a, b.to("cuda"))
                    for a, b in zip(outs[1:], cpu_out[1:]))
        grad = max((scaled_err(a, b.to("cuda"))
                    for a, b in zip(grads, cpu_grads) if b is not None),
                   default=0.0)
        ms = cuda_ms(lambda: breadth_run(fn, ins, wg), reps=3, warmup=1)
        rows[name] = {"fwd_bwd_ms": ms, "value_err": val, "grad_err": grad,
                      "exact_outputs_equal": exact}
        log(f"nn-breadth: {name} at {shape}, f32, card vs CPU: values "
            f"scaled err {val:.3g} (tol {TOL_BREADTH:g}), gradients "
            f"{grad:.3g} (tol {tol:g}), other outputs bitwise: {exact}; "
            f"forward + backward {ms:.4f} ms (CUDA events) [{power}]")
        if val > TOL_BREADTH or grad > tol or not exact:
            fail(f"nn-breadth: {name} on the card disagrees with the CPU")
        del ins, outs, grads, cpu_out, cpu_grads, wg
    torch.cuda.empty_cache()
    return rows


def group_norm_swap(nn, model, groups=None, **kw):
    """Every BatchNorm2D sublayer of ``model`` replaced, by name, with
    GroupNorm(groups, its channels), GN_GROUPS by default (Wu and He,
    Group Normalization, ECCV 2018): the port's ResNet takes no norm
    layer, as the reference's does not, so the swap goes through the Layer
    API, ``named_sublayers`` and then ``setattr`` on the parent."""
    layers = dict(model.named_sublayers(include_self=True))
    for name, layer in list(layers.items()):
        if isinstance(layer, nn.BatchNorm2D):
            parent, _, attr = name.rpartition(".")
            setattr(layers[parent], attr, nn.GroupNorm(
                groups or GN_GROUPS, layer.weight.shape[0],
                device=layer.weight.device, **kw))
    return model


def check_small_gn(nn, F, resnet18):
    """resnet18-GN (num_classes=10) at B=SMALL_VISION_B, 64x64, card
    against CPU from one state: a training-mode f32 forward's loss and
    logits within TOL_VISION_F32, beside a planted fault (16 groups in
    place of 32) that must be above it; and the port's group_norm alone at
    a ResNet stage's shape, forward and backward (input, weight, bias),
    f32, within TOL_VISION_F32.  The model's gradients are not compared:
    GroupNorm's statistics are f32 in f64 too (the reference's rule), so a
    ReLU kink within their rounding of 0 can flip between the devices (the
    reason phase 13 compares its gradients in f64 evaluation mode, where
    BatchNorm is affine).  Returns the readings by name."""
    import torch
    x, y = (torch.from_numpy(a) for a in vision_batch(
        SMALL_VISION_B, 3, SMALL_VISION_HW, 10, seed=2))
    torch.manual_seed(0)
    cpu = group_norm_swap(nn, resnet18(num_classes=10, device="cpu"))
    state = cpu.state_dict()

    def card(groups=None):
        m = group_norm_swap(nn, resnet18(num_classes=10), groups)
        missing, unexpected = m.set_state_dict(state)
        if missing or unexpected:
            fail(f"resnet18-GN state: missing {missing}, unexpected "
                 f"{unexpected}")
        return m

    def forward(m, dev):
        with torch.no_grad():
            out = m(x.to(dev))
            return out.cpu(), F.cross_entropy(out, y.to(dev)).mean().cpu()
    out_c, loss_c = forward(cpu, "cpu")
    out_g, loss_g = forward(card(), "cuda")
    r = {"train_f32": max(scaled_err(out_g, out_c),
                          scaled_err(loss_g, loss_c))}
    r["fault_16_groups"] = scaled_err(forward(card(16), "cuda")[0], out_c)
    g = torch.Generator().manual_seed(0)
    a = torch.randn(8, 256, 16, 16, generator=g) * 2 + 1
    wb = [torch.rand(256, generator=g) + 0.5, torch.randn(256, generator=g)]
    dy = torch.randn(8, 256, 16, 16, generator=g)

    def run(dev):
        ts = [t.to(dev).requires_grad_() for t in [a] + wb]
        out = F.group_norm(ts[0], GN_GROUPS, 1e-5, ts[1], ts[2])
        out.backward(dy.to(dev))
        return [out.detach().cpu()] + [t.grad.cpu() for t in ts]
    r["group_norm_f32"] = max(scaled_err(p, q) for p, q in zip(
        run("cuda"), run("cpu")))
    return r


def resnet50_gn_phase(nn, F, resnet18, resnet50, TrainStep, Momentum, power,
                      bn_step_ms):
    """resnet50-gn: check_small_gn, then ResNet-50 with every BatchNorm2D a
    GroupNorm(32, C) trained as bench_resnet50 trains resnet50-train:
    TrainStep O2 bf16, Momentum(0.1, 0.9), B=VISION_B at 224x224 from
    default_rng(0), one warm-up then VISION_STEPS steps: step ms,
    samples/s, peak bytes, and the device's busy and idle split of one more
    step (torch.profiler); losses finite, every parameter moved, no buffer
    left (GroupNorm keeps no running statistics)."""
    import torch
    sv = check_small_gn(nn, F, resnet18)
    log(f"resnet50-gn small check (resnet18-GN, B={SMALL_VISION_B}, "
        f"{SMALL_VISION_HW}x{SMALL_VISION_HW}) card vs CPU: training-mode "
        f"f32 loss and logits err={sv['train_f32']:.3g} (tol "
        f"{TOL_VISION_F32:g}); planted fault (16 groups) "
        f"{sv['fault_16_groups']:.3g}; group_norm alone at 8x256x16x16, "
        f"forward and backward, err={sv['group_norm_f32']:.3g} (tol "
        f"{TOL_VISION_F32:g})")
    if max(sv["train_f32"], sv["group_norm_f32"]) > TOL_VISION_F32:
        fail("resnet18-GN or group_norm on the card disagrees with the CPU")
    if sv["fault_16_groups"] <= TOL_VISION_F32:
        fail("the planted GroupNorm fault is not above TOL_VISION_F32")
    model = group_norm_swap(nn, resnet50(num_classes=1000))
    n_gn = sum(isinstance(m, nn.GroupNorm) for m in model.sublayers())
    if n_gn != 53 or any(isinstance(m, nn.BatchNorm2D)
                         for m in model.sublayers()) or model.buffers():
        fail(f"resnet50-GN has {n_gn} GroupNorms of 53, a BatchNorm2D or "
             "a buffer left")
    step = TrainStep(model, vision_loss, Momentum(learning_rate=0.1,
                                                  momentum=0.9),
                     amp_level="O2", amp_dtype="bfloat16")
    x, y = (torch.as_tensor(a, device="cuda") for a in vision_batch(
        VISION_B, 3, VISION_HW, 1000))
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    losses = [step(x, y)]
    e0.record()
    for _ in range(VISION_STEPS):
        losses.append(step(x, y))
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / VISION_STEPS
    peak = torch.cuda.max_memory_allocated()
    busy, traced = device_busy_ms(lambda: step(x, y))
    losses = [float(v) for v in losses]
    log(f"resnet50-gn: resnet50(num_classes=1000) with {n_gn} "
        f"GroupNorm({GN_GROUPS}, C), {len(p0)} parameter tensors; "
        f"TrainStep(amp_level='O2', bf16), Momentum(0.1, 0.9), B={VISION_B} "
        f"at {VISION_HW}x{VISION_HW}, one warm-up then {VISION_STEPS} steps:"
        f" step {ms:.3f} ms (CUDA events; resnet50-train's BatchNorm step "
        f"in this run {bn_step_ms:.3f} ms), {VISION_B / ms * 1e3:.1f} "
        f"samples/s, max_memory_allocated {peak} bytes; one traced step: "
        f"device busy {busy:.3f} ms, idle share {1 - busy / ms:.3f} of the "
        f"untraced step [{power}]; losses {losses}")
    if not all(math.isfinite(v) for v in losses):
        fail("a resnet50-gn training loss is not finite")
    for n, p in model.named_parameters():
        if torch.equal(p.detach(), p0[n]):
            fail(f"resnet50-gn parameter {n} did not move")
    del model, step, p0, x, y
    torch.cuda.empty_cache()
    return {"step_ms": ms, "samples_per_s": VISION_B / ms * 1e3,
            "peak_bytes": peak, "busy_ms": busy, "traced_wall_ms": traced,
            "idle_share": 1 - busy / ms, "bn_step_ms": bn_step_ms,
            "losses": losses, "small": sv}


def sn_dcgan_models(nn, ngf, ndf, device="cuda"):
    """dcgan_models with nn.utils.spectral_norm on each of D's five
    convolutions, as SN-GAN (Miyato et al., ICLR 2018) normalises its
    discriminator."""
    g, d = dcgan_models(nn, ngf, ndf, device=device)
    for layer in d.sublayers():
        if isinstance(layer, nn.Conv2D):
            nn.utils.spectral_norm(layer)
    return g, d


def sn_dcgan_phase(nn, topt, power, dcgan_ms):
    """sn-dcgan: the small SN-DCGAN (ngf = ndf = DCGAN_SMALL,
    B=DCGAN_SMALL_B) card against CPU at phase 25's limits (losses,
    gradients, one Adam step's moves; the spectral vectors take no
    gradient on either and do not move), then the published widths at
    B=DCGAN_B: ms an iteration beside dcgan's in this run, images/s, peak
    bytes; every parameter moved but the spectral vectors, which stay."""
    import torch
    torch.manual_seed(0)
    cpu = sn_dcgan_models(nn, DCGAN_SMALL, DCGAN_SMALL, device="cpu")
    gpu = sn_dcgan_models(nn, DCGAN_SMALL, DCGAN_SMALL)
    for a, b in zip(gpu, cpu):
        missing, unexpected = a.set_state_dict(b.state_dict())
        if missing or unexpected:
            fail(f"sn-dcgan state: missing {missing}, unexpected "
                 f"{unexpected}")
    bce = nn.BCEWithLogitsLoss()

    def adam(m):
        return topt.Adam(learning_rate=DCGAN_LR, beta1=0.5,
                         parameters=m.parameters())
    r = dcgan_card_vs_cpu(nn, cpu, gpu, adam, bce, DCGAN_SMALL_B)
    log(f"sn-dcgan small (ngf = ndf = {DCGAN_SMALL}, B={DCGAN_SMALL_B}, "
        f"spectral_norm on D's 5 convolutions) card vs CPU as dcgan's: "
        f"{dcgan_check_line(r)} (tol {TOL_F32:g}); no gradient on either: "
        f"{len(r['none'])} tensors")
    if max(r[k] for k in DCGAN_CHECKS) > TOL_F32:
        fail(f"the small SN-DCGAN on the card disagrees with the CPU: "
             f"{dcgan_check_line(r)} (tol {TOL_F32:g})")
    if len(r["none"]) != 10 or not all("_spectral_norm.weight_" in k
                                       for k in r["none"]):
        fail(f"sn-dcgan: the tensors without a gradient are {r['none']}")
    del cpu, gpu
    torch.manual_seed(0)
    gm, dm = sn_dcgan_models(nn, DCGAN_WIDTH, DCGAN_WIDTH)
    still = {f"d.{n}" for n, _ in dm.named_parameters()
             if "_spectral_norm.weight_" in n}
    ms, peak, losses = dcgan_timed(gm, dm, adam(gm), adam(dm), bce,
                                   "sn-dcgan", power, still)
    log(f"sn-dcgan: {ms:.3f} ms an iteration against dcgan's {dcgan_ms:.3f}"
        f" in this run ({ms / dcgan_ms:.3f}x)")
    del gm, dm
    torch.cuda.empty_cache()
    return {"iteration_ms": ms, "images_per_s": DCGAN_B / ms * 1e3,
            "peak_bytes": peak, "dcgan_iteration_ms": dcgan_ms,
            "small_errs": [r[k] for k in DCGAN_CHECKS],
            "first_last_losses": [losses[0], losses[-1]]}


def sparse_loss(emb, ids):
    """Half the sum of squares of the rows looked up: each id's gradient
    is its row, so SGD at lr 0.1 shrinks a row seen k times by 1 - 0.1 k."""
    return (emb(ids) ** 2).sum() * 0.5


def sparse_small_check(nn, topt, make_opt):
    """A (SPARSE_SMALL_V, SPARSE_SMALL_D) Embedding(sparse=True,
    padding_idx=0), card against CPU from one state: SPARSE_SMALL_STEPS
    eager steps on ids with repeats and the padding id; max |card - CPU|
    over the table and every optimizer state."""
    import numpy as np
    import torch
    r = np.random.default_rng(1)
    ids = r.integers(0, SPARSE_SMALL_V // 5, (8, 64))
    ids[0, :7] = 0
    ids[1, :9] = 3
    runs = []
    for dev in ("cpu", "cuda"):
        torch.manual_seed(0)
        emb = nn.Embedding(SPARSE_SMALL_V, SPARSE_SMALL_D, padding_idx=0,
                           sparse=True, device="cpu").to(dev)
        opt = make_opt(topt, emb.parameters())
        t = torch.as_tensor(ids, device=dev)
        for _ in range(SPARSE_SMALL_STEPS):
            sparse_loss(emb, t).backward()
            if not emb.weight.grad.is_sparse:
                fail("Embedding(sparse=True) gave a dense gradient")
            opt.step()
            opt.clear_grad()
        runs.append([emb.weight.detach().cpu()] + [
            v.cpu() for v in opt._accumulators[id(emb.weight)].values()])
    return max(float((a - b).abs().max()) for a, b in zip(*runs))


def sparse_embedding_phase(nn, topt, SelectedRows, power):
    """sparse-embedding: sparse_small_check for SGD and Adam(lazy_mode=
    True) within TOL_SPARSE; then a (SPARSE_V, SPARSE_D) f32 table at GPT-2
    345M's vocabulary fed one GPT-2 batch of B x S ids (default_rng(0)) a
    step, trained eagerly by each optimizer with sparse=True and beside it
    the same table with sparse=False: SPARSE_WARM warm-ups, then
    SPARSE_STEPS steps, ms a step (CUDA events) and the host's ms until a
    step returns; the merged rows of a step; losses finite; the sparse
    table within TOL_SPARSE of the dense one (one batch: the rows the
    dense update moves are the rows the sparse one does)."""
    import numpy as np
    import torch
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, SPARSE_V, (B, S)), device="cuda")
    opts = {"SGD": lambda O, P: O.SGD(learning_rate=0.1, parameters=P),
            "Adam(lazy_mode=True)": lambda O, P: O.Adam(
                learning_rate=1e-3, lazy_mode=True, parameters=P)}
    rows = {}
    for name, make in opts.items():
        err = sparse_small_check(nn, topt, make)
        log(f"sparse-embedding small ({SPARSE_SMALL_V}x{SPARSE_SMALL_D}, "
            f"padding_idx=0, repeated ids) {name}, {SPARSE_SMALL_STEPS} "
            f"steps card vs CPU: table and states max_abs_err {err:.3g} "
            f"(tol {TOL_SPARSE:g})")
        if err > TOL_SPARSE:
            fail(f"sparse-embedding {name} on the card disagrees with the "
                 "CPU")
        row = {"small_err": err}
        tables = {}
        for sparse in (True, False):
            torch.manual_seed(0)
            emb = nn.Embedding(SPARSE_V, SPARSE_D, sparse=sparse)
            opt = make(topt, emb.parameters())

            def step(emb=emb, opt=opt):
                loss = sparse_loss(emb, ids)
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss.detach()
            if sparse:
                sparse_loss(emb, ids).backward()
                row["merged_rows"] = int(SelectedRows.from_grad(
                    emb.weight.grad).merge().rows.numel())
                opt.clear_grad()
            for _ in range(SPARSE_WARM):
                step()
            losses, ms, host = eager_loop(step, SPARSE_STEPS)
            if not all(math.isfinite(v) for v in losses):
                fail(f"sparse-embedding {name} sparse={sparse}: a loss is "
                     "not finite")
            key = "sparse" if sparse else "dense"
            row[f"{key}_step_ms"], row[f"{key}_host_ms"] = ms, host
            row[f"{key}_losses"] = [losses[0], losses[-1]]
            tables[key] = emb.weight.detach()
            del emb, opt
        row["sparse_vs_dense_err"] = float(
            (tables["sparse"] - tables["dense"]).abs().max())
        log(f"sparse-embedding: ({SPARSE_V}, {SPARSE_D}) f32, ids "
            f"{B}x{S} a step ({row['merged_rows']} merged rows), {name}: "
            f"sparse {row['sparse_step_ms']:.4f} ms a step (host "
            f"{row['sparse_host_ms']:.4f} ms), dense "
            f"{row['dense_step_ms']:.4f} ms (host {row['dense_host_ms']:.4f}"
            f" ms), CUDA events over {SPARSE_STEPS} steps after "
            f"{SPARSE_WARM} warm-ups [{power}]; tables after "
            f"{SPARSE_WARM + SPARSE_STEPS} steps max |sparse - dense| "
            f"{row['sparse_vs_dense_err']:.3g} (tol {TOL_SPARSE:g})")
        if row["sparse_vs_dense_err"] > TOL_SPARSE:
            fail(f"sparse-embedding {name}: the sparse table left the dense "
                 "one")
        rows[name] = row
        del tables
    torch.cuda.empty_cache()
    return rows


def norm_draws():
    """norm-breadth's inputs as numpy f32 arrays from default_rng(0),
    drawn once for both devices and both dtypes: x at ResNet-50 stage 2's
    activation NB_SHAPE, the norms' weight and bias, the 1x1 conv's
    weight."""
    import numpy as np
    r = np.random.default_rng(0)
    c = NB_SHAPE[1]

    def n(*shape, scale=1.0, shift=0.0):
        return r.standard_normal(shape).astype(np.float32) * scale + shift
    x = n(*NB_SHAPE, shift=0.5)
    w, b = n(c, scale=0.2, shift=1.0), n(c)
    conv_w = r.standard_normal((NB_CONV_OUT, c, 1, 1)).astype(
        np.float32) * 0.05
    return x, w, b, conv_w


def norm_cases(nn, F, dev, dtype, draws):
    """norm-breadth's (name, fn, inputs) from ``draws`` (norm_draws) in
    ``dtype`` on ``dev``: each fn returns its output and the tensors
    whose gradient is compared."""
    import torch
    x_np, w_np, b_np, conv_w = draws
    c = NB_SHAPE[1]

    def t(a):
        return torch.as_tensor(a, device=dev).to(dtype)
    x, w, b = t(x_np), t(w_np), t(b_np)
    xh = x.permute(0, 2, 3, 1).contiguous()
    conv = nn.Conv2D(c, NB_CONV_OUT, 1, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(conv_w))
    conv = nn.utils.weight_norm(conv.to(dev, dtype))

    def wn_conv(a):
        return conv(a), [conv.weight_g, conv.weight_v, conv.bias]
    return [
        ("instance_norm", lambda a, ww, bb: F.instance_norm(
            a, weight=ww, bias=bb), [x, w, b]),
        ("group_norm NCHW", lambda a, ww, bb: F.group_norm(
            a, GN_GROUPS, 1e-5, ww, bb), [x, w, b]),
        ("group_norm NHWC", lambda a, ww, bb: F.group_norm(
            a, GN_GROUPS, 1e-5, ww, bb, "NHWC"), [xh, w, b]),
        ("local_response_norm", lambda a: F.local_response_norm(
            a, 5, 1e-4, 0.75, 2.0), [x]),
        ("normalize", lambda a: F.normalize(a, axis=1), [x]),
        (f"weight_norm Conv2D({c}, {NB_CONV_OUT}, 1)", wn_conv, [x]),
    ]


def norm_run(fn, inputs, w=None, weights=None):
    """fn(*inputs) with every input differentiated: (output, gradients of
    sum(out * w) over the inputs and the tensors fn names, w).  Without
    ``w``, w is randn of the output's shape from a generator seeded 1,
    drawn once a shape into ``weights`` (the same values every case and
    dtype would draw)."""
    import torch
    ins = [t.detach().requires_grad_() for t in inputs]
    out = fn(*ins)
    out, extra = out if isinstance(out, tuple) else (out, [])
    if w is None:
        key = tuple(out.shape)
        if weights is None or key not in weights:
            drawn = torch.randn(out.shape, generator=torch.Generator(
                ).manual_seed(1))
            if weights is not None:
                weights[key] = drawn
        else:
            drawn = weights[key]
        w = drawn.to(out.dtype)
    grads = torch.autograd.grad((out * w.to(out.device)).sum(),
                                ins + extra)
    return out.detach(), grads, w


def norm_breadth(nn, F, power):
    """norm-breadth: each norm_cases case at NB_SHAPE, f32 and bf16, on
    the card against the CPU: values within TOL_BREADTH (f32) or TOL_BF16
    (bf16) and every gradient within TOL_F32 (f32) or TOL_GRAD_BF16 (bf16)
    by scaled_err, and the forward + backward ms on the card; a planted
    fault must be above each dtype's limit: PyTorch's own LRN (alpha over
    size) in f32, group_norm over 16 groups in bf16.  The inputs and the
    output weights are drawn once for every case and dtype."""
    import torch
    rows = {}
    draws, weights = norm_draws(), {}
    for dt, (tv, tg) in ((torch.float32, (TOL_BREADTH, TOL_F32)),
                         (torch.bfloat16, (TOL_BF16, TOL_GRAD_BF16))):
        tag = str(dt).replace("torch.", "")
        want_cases = norm_cases(nn, F, "cpu", dt, draws)
        check_cases = norm_cases(nn, F, "cuda", dt, draws)
        for (name, fn, ins), (_, gfn, gins) in zip(want_cases, check_cases):
            want, wgrads, w = norm_run(fn, ins, weights=weights)
            wg = w.to("cuda")
            got, grads, _ = norm_run(gfn, gins, wg)
            # the CPU's results go to the card, where the measure is taken
            val = scaled_err(got, want.to("cuda"))
            grad = max(scaled_err(a, b.to("cuda"))
                       for a, b in zip(grads, wgrads))
            ms = cuda_ms(lambda: norm_run(gfn, gins, wg), reps=3, warmup=1)
            rows[f"{name} {tag}"] = {"fwd_bwd_ms": ms, "value_err": val,
                                     "grad_err": grad}
            log(f"norm-breadth: {name} at {'x'.join(map(str, NB_SHAPE))} "
                f"{tag}, card vs CPU: values scaled err {val:.3g} (tol "
                f"{tv:g}), gradients {grad:.3g} (tol {tg:g}); forward + "
                f"backward {ms:.4f} ms (CUDA events) [{power}]")
            if val > tv or grad > tg:
                fail(f"norm-breadth: {name} {tag} on the card disagrees "
                     "with the CPU")
            if name == "group_norm NCHW":
                gn_want = want
            if name == "local_response_norm":
                lrn_want = want
            del want, wgrads, got, grads, wg
        x, w_, b_ = check_cases[1][2]
        with torch.no_grad():
            if dt == torch.float32:
                fault = "torch.nn.functional.local_response_norm"
                err = scaled_err(torch.nn.functional.local_response_norm(
                    x, 5, 1e-4, 0.75, 2.0), lrn_want.to("cuda"))
            else:
                fault = "group_norm over 16 groups"
                err = scaled_err(F.group_norm(x, 16, 1e-5, w_, b_),
                                 gn_want.to("cuda"))
        rows[f"fault {tag}"] = err
        log(f"norm-breadth: planted fault ({fault}) {tag}: {err:.3g} (tol "
            f"{tv:g})")
        if err <= tv:
            fail(f"norm-breadth: the planted {tag} fault is within the "
                 "limit")
        del x, w_, b_, want_cases, check_cases
        torch.cuda.empty_cache()
    return rows


def rnn_amp_phase(nn, amp, power):
    """rnn-amp: phase 19's LSTM and GRU (RNN_LAYERS layers, bidirect,
    hidden RNN_H over inputs RNN_IN, B=RNN_B, T=RNN_T with sequence
    lengths) and an RNN over one LSTMCell(RNN_IN, RNN_H), card against CPU
    from one state under auto_cast O2 and under O1 with
    custom_white_list={"lstm_cell"}: each op's input dtypes (amp.trace_ops,
    logged and required: the layers' ops LSTM / GRU bf16 under O2 and f32
    under that O1, whose list names only the cell; the cell's op lstm_cell
    bf16 under both); outputs and states, and every gradient, by
    scaled_err within TOL_RNN_BF16 and TOL_RNN_GRAD_BF16 where the op runs
    in bf16 (TOL_F32 where it stays f32), beside a planted fault under O2
    (a forget or update gate's bias off by RNN_FAULT on the card) that
    must be above TOL_RNN_BF16; forward + backward ms on the card."""
    import copy

    import numpy as np
    import torch
    r = np.random.default_rng(0)
    x = torch.as_tensor(r.standard_normal((RNN_B, RNN_T, RNN_IN)).astype(
        np.float32))
    lens = torch.as_tensor(r.integers(RNN_T // 2, RNN_T + 1, (RNN_B,)))
    w = torch.as_tensor(r.standard_normal((RNN_B, RNN_T, 2 * RNN_H))
                        .astype(np.float32))
    rows, bad = {}, []
    for kind in ("LSTM", "GRU", "RNN(LSTMCell)"):
        torch.manual_seed(0)
        if kind == "RNN(LSTMCell)":
            cpu = nn.RNN(nn.LSTMCell(RNN_IN, RNN_H, device="cpu"))
        else:
            cpu = getattr(nn, kind)(RNN_IN, RNN_H, RNN_LAYERS,
                                    direction="bidirect", device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        faulty = copy.deepcopy(gpu)
        with torch.no_grad():
            for n, p in faulty.named_parameters():
                if "bias_hh" in n:            # gates i, f, g, o / r, z, c
                    p.view(-1, RNN_H)[1] += RNN_FAULT
        op = {"RNN(LSTMCell)": "lstm_cell"}.get(kind, kind)

        def run(m, level, white):
            dev = next(iter(m.parameters())).device
            xt = x.to(dev).requires_grad_()
            with amp.auto_cast(level=level, custom_white_list=white), \
                    amp.trace_ops() as trace:
                if kind == "RNN(LSTMCell)":
                    out, st = m(xt)
                else:
                    out, st = m(xt, sequence_length=lens.to(dev))
            loss = (out.float() * w[..., :out.shape[-1]].to(dev)).sum()
            grads = torch.autograd.grad(loss / RNN_B, [xt, *m.parameters()])
            st = st if isinstance(st, tuple) else (st,)
            return [out.detach(), *(s.detach() for s in st)], grads, trace
        for level, white in (("O2", None), ("O1", {"lstm_cell"})):
            outs_g, grads_g, trace = run(gpu, level, white)
            outs_c, grads_c, trace_c = run(cpu, level, white)
            bf = level == "O2" or kind == "RNN(LSTMCell)"
            dt = torch.bfloat16 if bf else torch.float32
            ops = sorted({(n, len(ds), ",".join(sorted({
                str(d).replace("torch.", "") for d in ds})))
                for n, ds in trace})
            if ({n for n, _ in trace} != {op} or any(
                    set(ds) != {dt} for _, ds in trace)
                    or trace != trace_c):
                fail(f"rnn-amp {kind} {level}: ops and dtypes {ops}, "
                     f"expected {op} in {dt}")
            tv, tg = ((TOL_RNN_BF16, TOL_RNN_GRAD_BF16) if bf
                      else (TOL_F32, TOL_F32))
            # the CPU's results go to the card, where the measure is taken
            e_out = max(scaled_err(a, b.to(a.device))
                        for a, b in zip(outs_g, outs_c))
            e_grad = max(scaled_err(a, b.to(a.device))
                         for a, b in zip(grads_g, grads_c))
            ms = cuda_ms(lambda: run(gpu, level, white), reps=3, warmup=1)
            name = f"{kind} {level}" + (" +lstm_cell" if white else "")
            row = rows[name] = {
                "fwd_bwd_ms": ms, "out_err": e_out, "grad_err": e_grad,
                "ops": [list(o) for o in ops], "op_calls": len(trace)}
            if level == "O2":
                row["fault_out_err"] = max(
                    scaled_err(a, b.to(a.device))
                    for a, b in zip(run(faulty, level, white)[0], outs_c))
            log(f"rnn-amp: {name} (B={RNN_B}, T={RNN_T}, hidden {RNN_H}), "
                f"ops {ops} x{len(trace)}; card vs CPU: outputs and states "
                f"{e_out:.3g} (tol {tv:g}), gradients {e_grad:.3g} (tol "
                f"{tg:g})" + (f", planted fault {row['fault_out_err']:.3g}"
                              if "fault_out_err" in row else "")
                + f"; forward + backward {ms:.4f} ms (CUDA events) "
                f"[{power}]")
            if e_out > tv or e_grad > tg:
                bad.append(f"{name} disagrees with the CPU")
            if row.get("fault_out_err", tv + 1) <= tv:
                bad.append(f"{name}: the planted fault is within the limit")
        del cpu, gpu, faulty
    torch.cuda.empty_cache()
    if bad:
        fail("rnn-amp: " + "; ".join(bad))
    return rows


def eval_pair(make, xs, dtype):
    """``make(num_classes=1000)`` on the card and on the CPU in ``dtype``
    with the card's weights, in evaluation mode with the running stats of
    ``xs`` (one training forward with the momentum at 0), so that the
    activations keep their scale through the layers."""
    import torch
    gpu = make(num_classes=1000).to(dtype)
    cpu = make(num_classes=1000, device="cpu").to(dtype)
    with torch.no_grad():
        for a, b in zip(gpu.parameters(), cpu.parameters()):
            b.copy_(a.cpu())
        for sub in cpu.modules():
            if hasattr(sub, "_momentum"):
                sub._momentum = 0.0
        cpu(xs.to(dtype))
        for a, b in zip(gpu.buffers(), cpu.buffers()):
            a.copy_(b)
    return gpu.eval(), cpu.eval()


def dcn_v2_swap(nn, F, ops, model, device="cuda"):
    """Each ``layer4.<i>.conv2`` of a ResNet replaced, by name, with
    PaddleDetection's DeformableConvV2 (``dcn_v2_stages: [3]``): a 3x3
    convolution, zero-initialised, making 2 * 9 offsets ((dy, dx) a tap)
    and 9 masks (sigmoid), and a ``DeformConv2D`` with the block's stride
    and no bias.  Setting a block's ``swap_offsets`` plants a fault: the
    offsets read as (dx, dy).  Returns the model."""
    import torch
    zero = nn.ParamAttr(initializer=nn.initializer.Constant(0.0))

    class DeformableConvV2(nn.Layer):
        def __init__(self, conv):
            super().__init__()
            cout, cin = conv.weight.shape[:2]
            self.conv_offset = nn.Conv2D(cin, 27, 3, stride=conv._stride,
                                         padding=1, weight_attr=zero,
                                         bias_attr=zero, device=device)
            self.dcn = ops.DeformConv2D(cin, cout, 3, stride=conv._stride,
                                        padding=1, bias_attr=False,
                                        device=device)
            self.swap_offsets = False

        def forward(self, x):
            om = self.conv_offset(x)
            off = om[:, :18]
            if self.swap_offsets:
                off = torch.flip(off.reshape(off.shape[0], 9, 2,
                                             *off.shape[2:]), [2]).reshape(
                    off.shape)
            return self.dcn(x, off, F.sigmoid(om[:, 18:]))
    layers = dict(model.named_sublayers())
    for name, layer in list(layers.items()):
        parts = name.split(".")
        if len(parts) == 3 and parts[0] == "layer4" and parts[2] == "conv2":
            setattr(layers[f"layer4.{parts[1]}"], "conv2",
                    DeformableConvV2(layer))
    return model


def yolov3_dcn(nn, F, ops, backbone, classes, device="cuda"):
    """YOLOv3 with DCNv2 in the backbone's last stage (PaddleDetection's
    ``yolov3_r50vd_dcn_270e_coco``; the JAX package has no detector, so
    neither has the port, and tests/torch_yolov3_common.py builds a tiny
    one in both packages): ``backbone`` (the port's ResNet, without pool or
    head) with ``dcn_v2_swap`` gives C3, C4 and C5 (strides 8, 16, 32);
    the YOLOv3 FPN runs detection blocks of 512, 256 and 128 channels on
    C5, then on C4 and C3 each concatenated after the previous block's
    route (a 1x1 ConvBN to half its channels, upsampled x2, nearest).  A
    block is five ConvBN-LeakyReLU(0.1) layers (1x1, 3x3, 1x1, 3x3, 1x1),
    its tip a 3x3 ConvBN to twice its channels, and its head a 1x1
    convolution with bias to 3 (5 + classes).  forward(x) returns the
    three heads, stride 32 first."""
    import torch
    body = dcn_v2_swap(nn, F, ops, backbone(num_classes=0, with_pool=False,
                                            device=device), device)
    c5 = body.inplanes

    def conv_bn(cin, cout, k):
        return nn.Sequential(
            nn.Conv2D(cin, cout, k, padding=k // 2, bias_attr=False,
                      device=device),
            nn.BatchNorm2D(cout, device=device), nn.LeakyReLU(0.1))

    class YOLOv3(nn.Layer):
        def __init__(self):
            super().__init__()
            self.backbone = body
            self.blocks = nn.LayerList()
            self.tips = nn.LayerList()
            self.heads = nn.LayerList()
            self.routes = nn.LayerList()
            for i, c in enumerate((512, 256, 128)):
                cin = c5 if i == 0 else c5 // 2 ** i + c
                self.blocks.append(nn.Sequential(
                    conv_bn(cin, c, 1), conv_bn(c, 2 * c, 3),
                    conv_bn(2 * c, c, 1), conv_bn(c, 2 * c, 3),
                    conv_bn(2 * c, c, 1)))
                self.tips.append(conv_bn(c, 2 * c, 3))
                self.heads.append(nn.Conv2D(2 * c, 3 * (5 + classes), 1,
                                            device=device))
                if i < 2:
                    self.routes.append(conv_bn(c, c // 2, 1))

        def forward(self, x):
            b = self.backbone
            x = b.maxpool(b.relu(b.bn1(b.conv1(x))))
            c3 = b.layer2(b.layer1(x))
            c4 = b.layer3(c3)
            outs, route = [], None
            for i, feat in enumerate((b.layer4(c4), c4, c3)):
                if route is not None:
                    feat = torch.cat([route, feat], 1)
                r = self.blocks[i](feat)
                outs.append(self.heads[i](self.tips[i](r)))
                if i < 2:
                    route = F.interpolate(self.routes[i](r), scale_factor=2,
                                          mode="nearest")
            return outs
    return YOLOv3()


def yolo_loss_sum(ops, outs, gt_box, gt_label, classes):
    """PaddleDetection's YOLOv3Loss over the three heads: yolo_loss at
    each (COCO's anchors and masks, downsample 32, 16, 8, ignore_thresh
    0.7, no label smoothing), averaged over the batch, summed."""
    total = 0
    for out, mask, down in zip(outs, YOLO_MASKS, YOLO_DOWN):
        total = total + ops.yolo_loss(out, gt_box, gt_label, YOLO_ANCHORS,
                                      mask, classes, YOLO_IGNORE, down,
                                      use_label_smooth=False).mean()
    return total


def yolo_batch(b, hw, classes, seed=0):
    """Images N(0, 1), then YOLO_GT gt rows an image of which YOLO_REAL
    are boxes (centres uniform over the image, w and h uniform in 2-60 %
    of it, xywh pixels) and the rest padding (w = h = 0), and labels, from
    one default_rng(seed)."""
    import numpy as np
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, 3, hw, hw)).astype(np.float32)
    box = np.zeros((b, YOLO_GT, 4), np.float32)
    box[:, :YOLO_REAL, :2] = r.uniform(0, hw, (b, YOLO_REAL, 2))
    box[:, :YOLO_REAL, 2:] = r.uniform(0.02, 0.6, (b, YOLO_REAL, 2)) * hw
    label = r.integers(0, classes, (b, YOLO_GT)).astype(np.int32)
    return x, box, label


def yolo_train_step(ops, model, opt, classes, x, box, label):
    """One step of PaddleDetection's eager loop: the loss, backward,
    opt.step(), opt.clear_grad(); returns the loss, detached."""
    loss = yolo_loss_sum(ops, model(x), box, label, classes)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def yolo_decode(ops, outs, img_size, classes):
    """yolo_box at each head (its three anchors, conf_thresh YOLO_CONF):
    [(boxes, scores)], stride 32 first."""
    res = []
    for out, mask, down in zip(outs, YOLO_MASKS, YOLO_DOWN):
        anchors = [a for i in mask for a in YOLO_ANCHORS[2 * i:2 * i + 2]]
        res.append(ops.yolo_box(out, img_size, anchors, classes, YOLO_CONF,
                                down))
    return res


def yolo_small_pair(nn, F, ops, resnet18):
    """The composition at YOLO_SMALL's size (resnet18 backbone with the
    same swap, 4 classes) on the CPU and on the card from one state; the
    offset convolutions drawn N(0, 0.01) instead of zeros, so that every
    sample moves (about a third of a pixel) and the offset layout
    matters."""
    import torch
    torch.manual_seed(0)
    cpu = yolov3_dcn(nn, F, ops, resnet18, YOLO_SMALL_CLASSES, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "conv_offset.weight" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.01)
    card = yolov3_dcn(nn, F, ops, resnet18, YOLO_SMALL_CLASSES)
    missing, unexpected = card.set_state_dict(cpu.state_dict())
    if missing or unexpected:
        fail(f"yolov3-dcn state: missing {missing}, unexpected {unexpected}")
    return cpu, card


def check_small_yolo(nn, F, ops, resnet18, Momentum, L2Decay):
    """yolov3-dcn's card-vs-CPU check at YOLO_SMALL's size: a training-mode
    f32 loss; then in f64 and evaluation mode (f32 ReLU and LeakyReLU kinks
    flip between devices, and training-mode batch norms keep f32
    statistics, as phase 13 explains) the loss, every gradient and the
    moves of one Momentum(YOLO_LR, 0.9, L2Decay(5e-4)) step, by scaled_err;
    beside them the planted fault (every block's offsets read as (dx, dy)),
    whose loss or gradients must be off by more than TOL_F32; then, for
    yolov3-dcn-serve, the f32 model in evaluation mode decoded by yolo_box,
    boxes and scores.  Returns the readings by name."""
    import torch
    b, hw, k = YOLO_SMALL_B, YOLO_SMALL_HW, YOLO_SMALL_CLASSES
    x, box, label = (torch.from_numpy(a) for a in yolo_batch(b, hw, k,
                                                             seed=3))
    cpu, card = yolo_small_pair(nn, F, ops, resnet18)
    r = {}

    def loss_on(m, dev, dtype=torch.float32):
        return yolo_loss_sum(ops, m(x.to(dev, dtype)), box.to(dev, dtype),
                             label.to(dev), k)
    with torch.no_grad():
        r["train_loss_f32"] = scaled_err(loss_on(card, "cuda").cpu(),
                                         loss_on(cpu, "cpu"))
        # the running stats that forward left, the CPU's on both
        for mine, theirs in zip(card.buffers(), cpu.buffers()):
            mine.copy_(theirs)
    cpu.eval()
    card.eval()
    img = torch.tensor([[hw, hw]] * b, dtype=torch.int32)
    with torch.no_grad():
        want = yolo_decode(ops, cpu(x), img, k)
        got = yolo_decode(ops, card(x.cuda()), img.cuda(), k)
    r["serve_f32"] = max(scaled_err(g.cpu(), w) for gs, ws in zip(got, want)
                         for g, w in zip(gs, ws))
    r["serve_kept"] = sum(int((w[1].abs().sum(-1) > 0).sum()) for w in want)
    (r["nms_bitwise"], r["nms_detections"], r["chain_kept"],
     r["chain_kept_fault"]) = check_small_yolo_nms(ops, want)
    cpu64, card64 = cpu.double(), card.double()

    def step(m, dev):
        old = {n: p.detach().clone() for n, p in m.named_parameters()}
        opt = Momentum(learning_rate=YOLO_LR, momentum=0.9,
                       parameters=m.parameters(),
                       weight_decay=L2Decay(YOLO_DECAY))
        loss = loss_on(m, dev, torch.float64)
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
        opt.step()
        opt.clear_grad()
        return loss.detach().cpu(), grads, old
    old = {n: p.detach().clone() for n, p in cpu64.named_parameters()}
    lc, gc, _ = step(cpu64, "cpu")
    for blk in card64.sublayers():
        if hasattr(blk, "swap_offsets"):
            blk.swap_offsets = True
    lf = loss_on(card64, "cuda", torch.float64)
    lf.backward()
    r["fault_loss"] = scaled_err(lf.detach().cpu(), lc)
    r["fault_grad"] = max(scaled_err(p.grad.cpu(), gc[n])
                          for n, p in card64.named_parameters())
    for blk in card64.sublayers():
        if hasattr(blk, "swap_offsets"):
            blk.swap_offsets = False
    card64.clear_gradients()
    lg, gg, _ = step(card64, "cuda")
    r["loss_f64"] = scaled_err(lg, lc)
    r["grad_f64"] = max(scaled_err(gg[n], gc[n]) for n in gc)
    r["moves_f64"] = moves_err(card64, cpu64, old, "yolov3-dcn small")
    return r


def yolov3_train_phase(nn, F, ops, resnet18, resnet50, Momentum, L2Decay,
                       power):
    """yolov3-dcn train: check_small_yolo, then the composition at full
    width (resnet50 backbone, 80 classes) trained as PaddleDetection's
    recipe: f32, Momentum(YOLO_LR, 0.9) with L2Decay(5e-4), B=YOLO_B at
    YOLO_HW, one warm-up then YOLO_STEPS eager steps: ms a step, images/s,
    peak bytes, the device's busy ms and idle share of one more step;
    every loss finite.  Then deform_conv2d beside Conv2D at
    layer4.1.conv2's shape (zero offsets, masks of 1: the same function)
    forward + backward.  Returns (the model, the readings by name)."""
    import torch
    sv = check_small_yolo(nn, F, ops, resnet18, Momentum, L2Decay)
    log(f"yolov3-dcn small check (resnet18 backbone, B={YOLO_SMALL_B}, "
        f"{YOLO_SMALL_HW}x{YOLO_SMALL_HW}, {YOLO_SMALL_CLASSES} classes) card"
        f" vs CPU: training-mode f32 loss err={sv['train_loss_f32']:.3g}; "
        f"f64 eval mode loss {sv['loss_f64']:.3g}, gradients "
        f"{sv['grad_f64']:.3g}, Momentum moves {sv['moves_f64']:.3g} (tol "
        f"{TOL_F32:g}); planted fault (offsets read as (dx, dy)) loss "
        f"{sv['fault_loss']:.3g}, gradients {sv['fault_grad']:.3g}")
    if max(sv["train_loss_f32"], sv["loss_f64"], sv["grad_f64"],
           sv["moves_f64"]) > TOL_F32:
        fail("the small yolov3-dcn on the card disagrees with the CPU")
    if max(sv["fault_loss"], sv["fault_grad"]) <= TOL_F32:
        fail("the planted offset-layout fault is not above TOL_F32")
    model = yolov3_dcn(nn, F, ops, resnet50, YOLO_CLASSES)
    n_dcn = sum(hasattr(m, "swap_offsets") for m in model.sublayers())
    if n_dcn != 3:
        fail(f"yolov3-dcn has {n_dcn} DCNv2 blocks, not 3")
    opt = Momentum(learning_rate=YOLO_LR, momentum=0.9,
                   parameters=model.parameters(),
                   weight_decay=L2Decay(YOLO_DECAY))
    x, box, label = (torch.as_tensor(a, device="cuda") for a in yolo_batch(
        YOLO_B, YOLO_HW, YOLO_CLASSES))

    def step():
        return yolo_train_step(ops, model, opt, YOLO_CLASSES, x, box, label)
    torch.cuda.reset_peak_memory_stats()
    warm = float(step())
    losses, ms, host = eager_loop(step, YOLO_STEPS)
    peak = torch.cuda.max_memory_allocated()
    busy, traced = device_busy_ms(step)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"yolov3-dcn train: resnet50 + DCNv2 in layer4 + YOLOv3 FPN, "
        f"{n_params} parameters, {YOLO_CLASSES} classes, f32, Momentum("
        f"{YOLO_LR:g}, 0.9) + L2Decay({YOLO_DECAY:g}), B={YOLO_B} at "
        f"{YOLO_HW}x{YOLO_HW}, {YOLO_GT} gt rows ({YOLO_REAL} real), one "
        f"warm-up then {YOLO_STEPS} eager steps: step {ms:.3f} ms (CUDA "
        f"events; host until step() returns {host:.3f} ms), "
        f"{YOLO_B / ms * 1e3:.2f} images/s, max_memory_allocated {peak} "
        f"bytes; one traced step: device busy {busy:.3f} ms, idle share "
        f"{1 - busy / ms:.3f} [{power}]; losses {[warm] + losses}")
    if not all(math.isfinite(v) for v in [warm] + losses):
        fail("a yolov3-dcn training loss is not finite")
    # deform_conv2d beside the convolution it replaces, layer4.1.conv2
    g = torch.Generator(device="cuda").manual_seed(5)
    xs = torch.randn(YOLO_B, 512, YOLO_HW // 32, YOLO_HW // 32,
                     generator=g, device="cuda").requires_grad_()
    conv = nn.Conv2D(512, 512, 3, padding=1, bias_attr=False)
    off = torch.zeros(YOLO_B, 18, *xs.shape[2:], device="cuda",
                      requires_grad=True)
    ones = torch.ones(YOLO_B, 9, *xs.shape[2:], device="cuda",
                      requires_grad=True)
    dy = torch.randn(xs.shape, generator=g, device="cuda")

    def dcn():
        out = ops.deform_conv2d(xs, off, conv.weight, padding=1, mask=ones)
        out.backward(dy)
        return out

    def plain():
        out = conv(xs)
        out.backward(dy)
        return out
    same = scaled_err(dcn().detach().cpu(), plain().detach().cpu())
    dcn_ms = cuda_ms(dcn, reps=5)
    conv_ms = cuda_ms(plain, reps=5)
    log(f"yolov3-dcn: deform_conv2d at layer4.1.conv2 ({YOLO_B}x512x"
        f"{xs.shape[2]}x{xs.shape[3]}, 3x3, zero offsets, masks of 1), "
        f"forward + backward {dcn_ms:.4f} ms against Conv2D's "
        f"{conv_ms:.4f} ms ({dcn_ms / conv_ms:.2f}x); outputs equal within "
        f"{same:.3g} (tol {TOL_F32:g}) [{power}]")
    if same > TOL_F32:
        fail("deform_conv2d at zero offsets is not the convolution")
    del xs, off, ones, dy, conv, opt, x, box, label
    torch.cuda.empty_cache()
    return model, {"step_ms": ms, "images_per_s": YOLO_B / ms * 1e3,
                   "host_ms": host, "peak_bytes": peak, "busy_ms": busy,
                   "traced_wall_ms": traced, "idle_share": 1 - busy / ms,
                   "losses": [warm] + losses, "params": n_params,
                   "dcn_fwd_bwd_ms": dcn_ms, "conv_fwd_bwd_ms": conv_ms,
                   "dcn_vs_conv": dcn_ms / conv_ms, "small": sv}


def yolov3_serve_phase(ops, model, power, small, fresh_model):
    """yolov3-dcn serve: the trained composition in evaluation mode, B=
    YOLO_B at YOLO_HW, forward then yolo_box at each head (YOLO_CONF,
    image YOLO_HW): ms a batch, images/s; finite boxes and scores of the
    expected shapes.  Then yolo_nms_readings over the three heads' boxes,
    of this composition and of ``fresh_model()`` (a freshly initialised
    one, its running stats from this batch, so that every box is a
    candidate: the training on random boxes leaves few or none above
    conf_thresh).  ``small`` is check_small_yolo's readings: the same
    decode card vs CPU at the small size, its NMS bitwise and the chain."""
    import torch
    small_err, small_kept = small["serve_f32"], small["serve_kept"]
    model.eval()
    x = torch.as_tensor(yolo_batch(YOLO_B, YOLO_HW, YOLO_CLASSES, seed=7)[0],
                        device="cuda")
    img = torch.full((YOLO_B, 2), YOLO_HW, dtype=torch.int32, device="cuda")

    def serve():
        with torch.no_grad():
            return yolo_decode(ops, model(x), img, YOLO_CLASSES)
    res = serve()
    for (boxes, scores), down in zip(res, YOLO_DOWN):
        n = 3 * (YOLO_HW // down) ** 2
        if tuple(boxes.shape) != (YOLO_B, n, 4) or tuple(scores.shape) != (
                YOLO_B, n, YOLO_CLASSES):
            fail(f"yolo_box at stride {down}: {tuple(boxes.shape)}, "
                 f"{tuple(scores.shape)}")
        if not bool(torch.isfinite(boxes).all() & torch.isfinite(
                scores).all()):
            fail("yolov3-dcn serve: a box or score is not finite")
    kept = sum(int((s.abs().sum(-1) > 0).sum()) for _, s in res)
    ms = cuda_ms(serve, reps=5, warmup=1)
    log(f"yolov3-dcn serve: eval(), B={YOLO_B} at {YOLO_HW}x{YOLO_HW}, "
        f"forward + yolo_box at 3 heads (conf_thresh {YOLO_CONF:g}): "
        f"{ms:.3f} ms a batch (CUDA events), {YOLO_B / ms * 1e3:.2f} "
        f"images/s, {kept} boxes above the threshold [{power}]; small "
        f"composition in eval mode card vs CPU, boxes and scores err="
        f"{small_err:.3g} (tol {TOL_F32:g}, {small_kept} boxes kept)")
    if small_err > TOL_F32:
        fail("the small yolov3-dcn's yolo_box on the card disagrees with "
             "the CPU")
    boxes, scores = yolo_nms_inputs(res)
    del model, res
    torch.cuda.empty_cache()
    nms = {"trained": yolo_nms_readings(ops, boxes, scores)}
    # the same decode from a freshly initialised composition (running stats
    # of this batch): every box a candidate, 1,000 a class after the cap
    fresh = fresh_model()
    with torch.no_grad():
        for sub in fresh.sublayers():
            if hasattr(sub, "_momentum"):
                sub._momentum = 0.0
        fresh(x)
        fresh.eval()
        boxes, scores = yolo_nms_inputs(yolo_decode(ops, fresh(x), img,
                                                    YOLO_CLASSES))
    del fresh, x
    torch.cuda.empty_cache()
    nms["fresh"] = yolo_nms_readings(ops, boxes, scores)
    for kind, v in nms.items():
        log(f"yolov3-dcn serve, {kind} composition: multiclass_nms over "
            f"{boxes.shape[1]} boxes and {scores.shape[1]} classes an image "
            f"({v['candidates']} candidates; score "
            f"{YOLO_NMS['score_threshold']:g}, nms_top_k "
            f"{YOLO_NMS['nms_top_k']}, keep {YOLO_NMS['keep_top_k']}, NMS "
            f"{YOLO_NMS['nms_threshold']:g}): {v['nms_ms']:.3f} ms (host to a "
            f"synchronize) beside the forward + yolo_box's {ms:.3f} ms, peak "
            f"{v['nms_peak_bytes']} bytes above its inputs; detections an "
            f"image {v['detections']}, largest same-class IoU "
            f"{v['worst_iou']:.3g}; the planted one-pass fault changes "
            f"{v['fault_changes']} detections; matrix_nms linear "
            f"{v['matrix_nms_linear_ms']:.3f} ms ({v['matrix_linear']}), "
            f"Gaussian {v['matrix_nms_gaussian_ms']:.3f} ms "
            f"({v['matrix_gaussian']}) [{power}]")
    log(f"yolov3-dcn serve, small composition: multiclass_nms on the CPU's "
        f"decode, card vs CPU bitwise {small['nms_bitwise']} "
        f"({small['nms_detections']} detections), the chain kept "
        f"{small['chain_kept']} of 3, under the planted fault "
        f"{small['chain_kept_fault']}")
    if not small["nms_bitwise"]:
        fail("the small yolov3-dcn's NMS on the card differs from the CPU's")
    if small["chain_kept"] != 2 or small["chain_kept_fault"] != 1:
        fail("multiclass_nms: the chain is not kept whole, or the planted "
             "one-pass fault does not cut it")
    del boxes, scores
    torch.cuda.empty_cache()
    return {"batch_ms": ms, "images_per_s": YOLO_B / ms * 1e3,
            "boxes_kept": kept, "nms": nms}


def yolo_nms_readings(ops, boxes, scores):
    """multiclass_nms (YOLO_NMS) over yolo_box's boxes and scores: ms, peak
    bytes above its inputs, candidates, detections an image (failing
    unless within keep_top_k, finite, and each class's kept boxes pairwise
    at most the NMS threshold), how many the planted one-pass fault
    changes; matrix_nms (YOLO_MATRIX) linear and Gaussian, ms and
    detections an image."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, num, _ = yolo_nms(ops, boxes, scores)
    peak = torch.cuda.max_memory_allocated() - base
    r = {"nms_ms": wall_ms(lambda: yolo_nms(ops, boxes, scores)),
         "nms_peak_bytes": peak, "detections": num.tolist(),
         "candidates": int((scores > YOLO_NMS["score_threshold"]).sum()),
         "fault_changes": detections_changed(
             ops, lambda: yolo_nms(ops, boxes, scores))}
    start, worst = 0, 0.0
    for k in r["detections"]:
        worst = max(worst, nms_overlap(ops, out[start:start + k]))
        start += k
    r["worst_iou"] = worst
    if (max(r["detections"]) > YOLO_NMS["keep_top_k"]
            or worst > YOLO_NMS["nms_threshold"]
            or not bool(torch.isfinite(out).all())):
        fail("yolov3-dcn serve: the detections break NMS's invariants")
    for kind, gauss in (("linear", False), ("gaussian", True)):
        r[f"matrix_{kind}"] = ops.matrix_nms(
            boxes, scores, use_gaussian=gauss, gaussian_sigma=2.0,
            **YOLO_MATRIX)[1].tolist()
        r[f"matrix_nms_{kind}_ms"] = wall_ms(lambda: ops.matrix_nms(
            boxes, scores, use_gaussian=gauss, gaussian_sigma=2.0,
            **YOLO_MATRIX))
    return r


def one_pass_keep(boxes, valid, thresh, eta=1.0):
    """The planted NMS fault, in place of vision.ops._greedy_keep: one pass
    in which every better candidate suppresses, kept or not
    (``triu(iou > t, 1).any(0)``).  Greedy NMS differs wherever overlaps
    chain: A over B over C with A clear of C keeps C; this drops it."""
    import torch
    from paddle_tpu_torch.vision.ops import _pair_iou
    over = torch.triu((_pair_iou(boxes) > thresh) & valid[:, :, None], 1)
    return valid & ~over.any(1)


def det_rois(n_img, per_img, seed=0):
    """Mask R-CNN R50-FPN's RoIs on P2: per_img boxes an image of
    DET_IMG, corners uniform over it, w and h uniform in 16-160 pixels
    (what FPN routes to P2), clipped to the image; xyxy f32."""
    import numpy as np
    r = np.random.default_rng(seed)
    ih, iw = DET_IMG
    n = n_img * per_img
    x1 = r.uniform(0, iw - 16, n)
    y1 = r.uniform(0, ih - 16, n)
    x2 = np.minimum(x1 + r.uniform(16, 160, n), iw)
    y2 = np.minimum(y1 + r.uniform(16, 160, n), ih)
    return np.stack([x1, y1, x2, y2], 1).astype(np.float32)


def det_ops_phase(ops, power):
    """det-ops: roi_align at Mask R-CNN R50-FPN's P2 map (DET_MAP f32,
    DET_ROIS RoIs an image, spatial_scale DET_SCALE) at 7 and 14, aligned
    and not, and roi_pool at 7 on the same map (ReLU'd: ties): each card
    against the CPU on DET_CHECK RoIs (values by scaled_err within
    TOL_BREADTH, gradients within TOL_F32) beside a planted fault
    (aligned flipped; the far corner floored instead of ceiled), then
    forward + backward ms at every RoI; roi_pool's peak bytes beside what
    the reference's (R, oh, C, H, W) masked max would hold.  Then
    yolo_box, box_coder, prior_box and density_prior_box at SSD300's 38x38
    map, card against CPU (the priors bitwise), ms each.  Returns the
    readings by name."""
    import numpy as np
    import torch
    n_img = DET_MAP[0]
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        DET_MAP).astype(np.float32))
    boxes = torch.as_tensor(det_rois(n_img, DET_ROIS))
    bn = torch.tensor([DET_ROIS] * n_img)
    per = DET_CHECK // n_img
    pick = torch.cat([torch.arange(per) + i * DET_ROIS
                      for i in range(n_img)])
    sub, sub_bn = boxes[pick], torch.tensor([per] * n_img)
    far_floor = torch.cat([sub[:, :2], torch.floor(
        sub[:, 2:] * DET_SCALE) / DET_SCALE], 1)
    rows = {}
    cases = [(f"roi_align {o}x{o} aligned={al}", x,
              lambda a, b, n, o=o, al=al: ops.roi_align(
                  a, b, n, o, DET_SCALE, aligned=al),
              lambda a, b, n, o=o, al=al: ops.roi_align(
                  a, b, n, o, DET_SCALE, aligned=not al), sub)
             for o in (7, 14) for al in (True, False)]
    cases.append(("roi_pool 7x7", torch.relu(x),
                  lambda a, b, n: ops.roi_pool(a, b, n, 7, DET_SCALE),
                  lambda a, b, n: ops.roi_pool(a, b, n, 7, DET_SCALE),
                  far_floor))
    for name, xm, fn, fault_fn, fault_boxes in cases:
        want, wgrad, w = breadth_run(fn, [xm.clone(), sub.clone(), sub_bn])
        xg, bg = xm.cuda(), sub.cuda()
        got, ggrad, _ = breadth_run(fn, [xg, bg, sub_bn.cuda()], w.cuda())
        xg = xg.detach()
        val = scaled_err(got[0].cpu(), want[0])
        grad = max(scaled_err(a.cpu(), b) for a, b in zip(ggrad, wgrad)
                   if b is not None)
        fault = scaled_err(fault_fn(xg, fault_boxes.cuda(),
                                    sub_bn.cuda()).detach().cpu(), want[0])
        xf, bf = xm.cuda().requires_grad_(), boxes.cuda()
        if name.startswith("roi_align"):
            bf.requires_grad_()
        bnc = bn.cuda()
        dy = torch.randn(fn(xf, bf, bnc).shape, device="cuda")

        def fwd_bwd():
            fn(xf, bf, bnc).backward(dy)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = cuda_ms(fwd_bwd, reps=3, warmup=1)
        rows[name] = {"fwd_bwd_ms": ms, "value_err": val, "grad_err": grad,
                      "fault": fault, "peak_bytes_over_inputs": peak}
        log(f"det-ops: {name} at {'x'.join(map(str, DET_MAP))} f32, "
            f"{DET_ROIS * n_img} RoIs, scale {DET_SCALE:g}: card vs CPU on "
            f"{DET_CHECK} RoIs values {val:.3g} (tol {TOL_BREADTH:g}), "
            f"gradients {grad:.3g} (tol {TOL_F32:g}), planted fault "
            f"{fault:.3g}; forward + backward {ms:.4f} ms (CUDA events), "
            f"peak {peak} bytes above the inputs [{power}]")
        if val > TOL_BREADTH or grad > TOL_F32:
            fail(f"det-ops: {name} on the card disagrees with the CPU")
        if fault <= TOL_BREADTH:
            fail(f"det-ops: the planted fault of {name} is not above "
                 "TOL_BREADTH")
        del xg, bg, xf, bf, dy
    r_all = DET_ROIS * n_img
    naive = r_all * 7 * DET_MAP[1] * DET_MAP[2] * DET_MAP[3] * 4
    rows["roi_pool 7x7"]["reference_intermediate_bytes"] = naive
    pool_peak = rows["roi_pool 7x7"]["peak_bytes_over_inputs"]
    log(f"det-ops: roi_pool's peak {pool_peak} bytes against the {naive} "
        "bytes of the reference's (R, oh, C, H, W) masked max")
    rows.update(ssd_ops(ops, power))
    torch.cuda.empty_cache()
    return rows


def ssd_ops(ops, power):
    """yolo_box (B=8, 3 anchors, 80 classes), box_coder (decode of every
    prior of the map against N(0, 1) deltas) and SSD300's prior_box
    (min 30, max 60, ratio 2, flipped) and a density_prior_box (FaceBoxes'
    densities 4, 2, 1 at 32, 64, 128) at SSD300's 38x38 map: card against
    CPU (values within TOL_BREADTH, the priors bitwise), ms each."""
    import numpy as np
    import torch
    r = np.random.default_rng(2)
    hw = SSD_MAP
    feat = torch.zeros(1, 512, hw, hw)
    img = torch.zeros(1, 3, 300, 300)
    head = torch.as_tensor(r.standard_normal(
        (YOLO_B, 3 * (5 + YOLO_CLASSES), hw, hw)).astype(np.float32))
    size = torch.full((YOLO_B, 2), 300, dtype=torch.int32)
    anchors = YOLO_ANCHORS[12:18]
    cases = {
        "yolo_box": (lambda h, s: ops.yolo_box(h, s, anchors, YOLO_CLASSES,
                                               YOLO_CONF, 8), [head, size]),
        "prior_box": (lambda f, i: ops.prior_box(
            f, i, [30.0], [60.0], [2.0], flip=True, clip=True), [feat, img]),
        "density_prior_box": (lambda f, i: ops.density_prior_box(
            f, i, [4, 2, 1], [32.0, 64.0, 128.0], [1.0], clip=True),
            [feat, img])}
    pb = ops.prior_box(feat, img, [30.0], [60.0], [2.0], flip=True)
    m = pb[0].reshape(-1, 4).shape[0]
    cases["box_coder"] = (lambda p, v, t: ops.box_coder(
        p, v, t, "decode_center_size"), [pb[0].reshape(-1, 4),
                                         pb[1].reshape(-1, 4),
                                         torch.as_tensor(r.standard_normal(
                                             (m, 4)).astype(np.float32))])
    rows = {}
    for name, (fn, ins) in cases.items():
        want = fn(*ins)
        gins = [t.cuda() for t in ins]
        got = fn(*gins)
        bitwise = name.endswith("prior_box")
        if bitwise:
            err = 0.0 if all(torch.equal(a.cpu(), b)
                             and a.device.type == "cuda"
                             for a, b in zip(got, want)) else math.inf
        else:
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(scaled_err(a.cpu(), b) for a, b in zip(got, want))
        ms = cuda_ms(lambda: fn(*gins), reps=5, warmup=1)
        rows[f"ssd38 {name}"] = {"ms": ms, "err": err}
        limit = "bitwise" if bitwise else f"tol {TOL_BREADTH:g}"
        log(f"det-ops: {name} at SSD300's {hw}x{hw} map, card vs CPU err "
            f"{err:.3g} ({limit}); {ms:.4f} ms a call (CUDA events) "
            f"[{power}]")
        if err > TOL_BREADTH:
            fail(f"det-ops: {name} on the card disagrees with the CPU")
    return rows


def wall_ms(fn, reps=3, warmup=1):
    """Mean host milliseconds of fn() to a synchronize, for work that reads
    back to the host inside (the NMS and target stages), where launches
    queued behind a sleeping kernel (cuda_ms) would wait on themselves."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def yolo_nms_inputs(res):
    """yolo_box's heads, concatenated: boxes (N, M, 4), scores (N, C, M)."""
    import torch
    return (torch.cat([b for b, _ in res], 1),
            torch.cat([s for _, s in res], 1).transpose(1, 2).contiguous())


def yolo_nms(ops, boxes, scores):
    """multiclass_nms at PaddleDetection's YOLOv3 settings (YOLO_NMS)."""
    return ops.multiclass_nms(boxes, scores, return_index=True, **YOLO_NMS)


def chain_case(dev):
    """Three boxes in a chain: A over B (IoU 1/3), B over C, A clear of C;
    scores A > B > C.  Greedy NMS at 0.3 keeps A and C, the one-pass
    fault only A."""
    import torch
    b = torch.tensor([[0, 0, 10, 10], [5, 0, 15, 10], [10, 0, 20, 10]],
                     dtype=torch.float32, device=dev)
    return b, torch.tensor([0.9, 0.8, 0.7], device=dev)


class planted_nms:
    """Within it, vision.ops runs one_pass_keep in place of its greedy
    scan (the planted fault)."""

    def __init__(self, ops):
        self.ops = ops

    def __enter__(self):
        self.saved = self.ops._greedy_keep
        self.ops._greedy_keep = one_pass_keep

    def __exit__(self, *exc):
        self.ops._greedy_keep = self.saved


def check_small_yolo_nms(ops, want):
    """The small composition's multiclass_nms on the card, bitwise against
    the same call on the CPU fed the CPU's yolo_box output ``want``; then
    the chain, which greedy NMS keeps whole and the planted fault cuts.
    Returns (bitwise, detections, chain kept, chain kept under the
    fault)."""
    import torch
    boxes, scores = yolo_nms_inputs(want)
    c = yolo_nms(ops, boxes, scores)
    g = yolo_nms(ops, boxes.cuda(), scores.cuda())
    same = all(torch.equal(a.cpu(), b) and a.device.type == "cuda"
               for a, b in zip(g, c))
    b, s = chain_case("cuda")
    keep = ops.multiclass_nms(b[None], s[None, None], 0.0, -1, -1, 0.3)[1]
    with planted_nms(ops):
        cut = ops.multiclass_nms(b[None], s[None, None], 0.0, -1, -1, 0.3)[1]
    return same, int(c[1].sum()), int(keep[0]), int(cut[0])


def detections_changed(ops, run):
    """How many detections ``run()`` (returning (out, rois_num, index))
    gives that it does not give under the planted fault, and the
    reverse."""
    base = run()
    with planted_nms(ops):
        faulty = run()
    a = set(base[2].tolist())
    b = set(faulty[2].tolist())
    return len(a - b) + len(b - a)


def faster_rcnn_fpn(nn, F, backbone, cfg, device="cuda"):
    """Faster R-CNN with an FPN (PaddleDetection's
    ``faster_rcnn_r50_fpn_1x_coco``; the JAX package has no detector, so
    neither has the port, and tests/torch_faster_rcnn_common.py builds a
    tiny one in both packages): ``backbone`` (the port's ResNet, without
    pool or head) gives C2-C5 (strides 4-32); the FPN takes the stages
    ``cfg["stages"]`` through 1x1 laterals of ``cfg["fpn"]`` channels, the
    top-down path by nearest x2 upsampling and 3x3 outputs, and with
    ``cfg["p6"]`` P6 by a stride-2 max pool of the last; the RPN head is a
    3x3 convolution and ReLU, then 1x1 to A = 3 objectness logits and 4 A
    deltas; the RoI head (``roi_head``) two FC of ``cfg["fc"]`` (ReLU) to
    ``cfg["classes"]`` logits and 4 x as many deltas.  forward(x) returns
    ([(logits, deltas)] and the maps, one per level)."""
    body = backbone(num_classes=0, with_pool=False, device=device)
    widths = [c * body.inplanes // 512 for c in (64, 128, 256, 512)]
    stages = cfg["stages"]
    ch, A = cfg["fpn"], len(FRCNN_RATIOS)

    class FasterRCNN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.backbone = body
            self.laterals = nn.LayerList([nn.Conv2D(
                widths[s - 2], ch, 1, device=device) for s in stages])
            self.outputs = nn.LayerList([nn.Conv2D(
                ch, ch, 3, padding=1, device=device) for _ in stages])
            self.rpn = nn.Conv2D(ch, ch, 3, padding=1, device=device)
            self.rpn_obj = nn.Conv2D(ch, A, 1, device=device)
            self.rpn_reg = nn.Conv2D(ch, 4 * A, 1, device=device)
            n = cfg["classes"]
            self.fc1 = nn.Linear(ch * FRCNN_ROI * FRCNN_ROI, cfg["fc"],
                                 device=device)
            self.fc2 = nn.Linear(cfg["fc"], cfg["fc"], device=device)
            self.cls = nn.Linear(cfg["fc"], n, device=device)
            self.reg = nn.Linear(cfg["fc"], 4 * n, device=device)

        def forward(self, x):
            b = self.backbone
            c = [b.layer1(b.maxpool(b.relu(b.bn1(b.conv1(x)))))]
            for layer in (b.layer2, b.layer3, b.layer4)[:max(stages) - 2]:
                c.append(layer(c[-1]))
            lat = [m(c[s - 2]) for m, s in zip(self.laterals, stages)]
            for i in range(len(lat) - 2, -1, -1):
                lat[i] = lat[i] + F.interpolate(lat[i + 1], scale_factor=2,
                                                mode="nearest")
            feats = [m(t) for m, t in zip(self.outputs, lat)]
            if cfg["p6"]:
                feats.append(F.max_pool2d(feats[-1], 1, stride=2))
            heads = []
            for f in feats:
                h = F.relu(self.rpn(f))
                heads.append((self.rpn_obj(h), self.rpn_reg(h)))
            return heads, feats

        def roi_head(self, r):
            h = F.relu(self.fc2(F.relu(self.fc1(r.flatten(1)))))
            return self.cls(h), self.reg(h)
    return FasterRCNN()


class StageClock:
    """Host ms of the proposal and target stages: each call synchronizes
    before and after the stage (only in the one step it times)."""

    def __init__(self):
        self.ms = {"targets": 0.0, "proposals": 0.0}

    def __call__(self, kind, fn, *args, **kw):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        self.ms[kind] += (time.perf_counter() - t0) * 1e3
        return out


def _run_stage(clock, kind, fn, *args, **kw):
    return clock(kind, fn, *args, **kw) if clock else fn(*args, **kw)


def frcnn_anchors(ops, feats, cfg):
    return [ops.anchor_generator(f, [s], list(FRCNN_RATIOS),
                                 stride=(float(st), float(st)))
            for f, s, st in zip(feats, cfg["sizes"], cfg["strides"])]


def frcnn_proposals(ops, heads, levels, im_shape, n, pre, post, clock=None):
    """generate_proposals at every level (NMS 0.7, min_size 0), then
    collect_fpn_proposals to FRCNN_COLLECT an image: [(R_i, 4) f32]."""
    import torch
    per_level = []
    for (o, d), (a, v) in zip(heads, levels):
        rois, sc, num = _run_stage(
            clock, "proposals", ops.generate_proposals, torch.sigmoid(o), d,
            im_shape, a, v, pre, post, 0.7, 0.0, return_rois_num=True)
        per_level.append((rois.split(num.tolist()), sc.split(num.tolist())))
    return [_run_stage(clock, "proposals", ops.collect_fpn_proposals,
                       [r[i] for r, _ in per_level],
                       [s[i] for _, s in per_level], FRCNN_COLLECT)
            for i in range(n)]


def frcnn_roi_features(ops, feats, rois, nums, cfg, clock=None):
    """distribute_fpn_proposals of each image's RoIs to the RoI levels,
    roi_align (FRCNN_ROI, aligned) of every image's RoIs of a level in one
    call with boxes_num, the rows put back in the RoIs' order."""
    import torch
    lo, hi = cfg["roi_levels"]
    per_img, start = [], 0
    for n in nums:
        multi, restore, _ = _run_stage(
            clock, "proposals", ops.distribute_fpn_proposals,
            rois[start:start + n], lo, hi, cfg["refer"][0], cfg["refer"][1])
        per_img.append((multi, start + torch.argsort(restore)))
        start += n
    out, src = [], []
    for k in range(hi - lo + 1):
        f, st = feats[k], cfg["strides"][k]
        sizes = [len(m[k]) for m, _ in per_img]
        if not sum(sizes):
            continue
        out.append(ops.roi_align(f, torch.cat([m[k] for m, _ in per_img]),
                                 sizes, FRCNN_ROI, 1.0 / st, aligned=True))
        for m, order in per_img:
            lens = [len(t) for t in m]
            src.append(order[sum(lens[:k]):sum(lens[:k + 1])])
    if not out:
        return feats[0].new_zeros(0, feats[0].shape[1], FRCNN_ROI, FRCNN_ROI)
    feat = torch.cat(out)
    return feat[torch.argsort(torch.cat(src))]


def frcnn_loss(ops, F, model, x, gts, classes, crowd, im_info, cfg,
               clock=None):
    """The training loss of the composition on one batch: the RPN's
    sigmoid BCE on the sampled anchors and smooth L1 on the fg anchors
    over the sample's size (rpn_target_assign over every level's anchors),
    the proposals (FRCNN_TRAIN), generate_proposal_labels, RoIAlign at the
    levels distribute_fpn_proposals picks, softmax CE over the sampled
    RoIs and smooth L1 on their fg class slots over the RoIs' count.
    Returns (loss, the named samples)."""
    import torch
    n = x.shape[0]
    heads, feats = model(x)
    levels = frcnn_anchors(ops, feats, cfg)
    an_all = torch.cat([a.reshape(-1, 4) for a, _ in levels])
    logit = torch.cat([o.permute(0, 2, 3, 1).reshape(n, -1)
                       for o, _ in heads], 1)
    delta = torch.cat([d.reshape(n, len(FRCNN_RATIOS), 4, *d.shape[2:])
                       .permute(0, 3, 4, 1, 2).reshape(n, -1, 4)
                       for _, d in heads], 1)
    loc, score, tbox, tlab, _ = _run_stage(
        clock, "targets", ops.rpn_target_assign, an_all, gts, crowd,
        im_info, FRCNN_RPN_BATCH, 0.0, 0.5, 0.7, 0.3, use_random=True)
    l_cls = F.binary_cross_entropy_with_logits(
        logit.reshape(-1)[score.long()], tlab.to(logit.dtype))
    l_reg = F.smooth_l1_loss(delta.reshape(-1, 4)[loc.long()], tbox,
                             reduction="sum") / max(len(score), 1)
    pre, post = cfg["train_proposals"]
    props = frcnn_proposals(ops, [(o.detach(), d.detach())
                                  for o, d in heads], levels,
                            im_info[:, :2], n, pre, post, clock)
    rois, labels, tgts, inw, _, nums = _run_stage(
        clock, "targets", ops.generate_proposal_labels, props, classes,
        crowd, gts, batch_size_per_im=cfg["roi_batch"], fg_fraction=0.25,
        fg_thresh=0.5, bg_thresh_hi=0.5, bg_thresh_lo=0.0,
        bbox_reg_weights=FRCNN_REG_W, class_nums=cfg["classes"],
        use_random=True)
    feat = frcnn_roi_features(ops, feats, rois, nums.tolist(), cfg, clock)
    cls, reg = model.roi_head(feat)
    l_rcnn = F.cross_entropy(cls, labels.long())
    l_box = F.smooth_l1_loss(reg * inw, tgts * inw,
                             reduction="sum") / len(labels)
    samples = {"score_index": score, "loc_index": loc, "tgt_label": tlab,
               "rois": rois, "labels": labels, "nums": nums,
               "anchors": torch.tensor(len(an_all))}
    return l_cls + l_reg + l_rcnn + l_box, samples


def frcnn_serve(ops, F, model, x, im_info, cfg, clock=None, nms=None):
    """One request: test proposals (FRCNN_TEST), the RoI head, softmax,
    box_decoder_and_assign with FRCNN_REG_W as the variances, box_clip of
    each RoI's best-class box, then per image multiclass_nms (background
    0, FRCNN_SERVE).  Returns ([(out, rois_num, index)] an image, the
    decode's (boxes, probabilities) an image)."""
    import torch
    n = x.shape[0]
    with torch.no_grad():
        heads, feats = model(x)
        levels = frcnn_anchors(ops, feats, cfg)
        pre, post = cfg["test_proposals"]
        props = frcnn_proposals(ops, heads, levels, im_info[:, :2], n, pre,
                                post, clock)
        nums = [len(p) for p in props]
        rois = torch.cat(props)
        cls, reg = model.roi_head(frcnn_roi_features(ops, feats, rois, nums,
                                                     cfg, clock))
        prob = F.softmax(cls, -1)
        var = torch.tensor(FRCNN_REG_W, device=x.device).expand(len(rois), 4)
        _, assigned = ops.box_decoder_and_assign(rois, var, reg, prob)
        decoded, dets, start = [], [], 0
        for i, k in enumerate(nums):
            boxes = ops.box_clip(assigned[start:start + k], im_info[i, :2])
            p = prob[start:start + k].t()
            decoded.append((boxes, p))
            dets.append(_run_stage(nms, "nms", ops.multiclass_nms,
                                   boxes[None], p[None], return_index=True,
                                   **FRCNN_SERVE))
            start += k
    return dets, decoded


def frcnn_batch(b, img, gt, classes, seed=0, dtype=None):
    """Images N(0, 1) of ``img`` (h, w), and per image ``gt`` boxes (xyxy
    pixels inside the image, w and h uniform in 5-40 % of its sides,
    classes 1 .. classes - 1, none crowd), from one default_rng(seed), as
    yolo_batch draws YOLOv3's; im_info rows (h, w, 1)."""
    import numpy as np
    r = np.random.default_rng(seed)
    h, w = img
    x = r.standard_normal((b, 3, h, w)).astype(dtype or np.float32)
    gts, cls, crowd = [], [], []
    for _ in range(b):
        wh = r.uniform(0.05, 0.4, (gt, 2)) * [w, h]
        xy = r.uniform(0, 1, (gt, 2)) * ([w, h] - wh)
        gts.append(np.concatenate([xy, xy + wh], 1).astype(np.float32))
        cls.append(r.integers(1, classes, gt).astype(np.int64))
        crowd.append(np.zeros(gt, bool))
    im_info = np.array([[h, w, 1.0]] * b, np.float32)
    return x, gts, cls, crowd, im_info


def frcnn_small_pair(nn, F, resnet18):
    """The composition at FRCNN_SMALL's size on the CPU and on the card
    from one state, with the CPU's running stats of one training forward
    (as check_small_yolo)."""
    import torch
    torch.manual_seed(0)
    cpu = faster_rcnn_fpn(nn, F, resnet18, FRCNN_SMALL, device="cpu")
    card = faster_rcnn_fpn(nn, F, resnet18, FRCNN_SMALL)
    missing, unexpected = card.set_state_dict(cpu.state_dict())
    if missing or unexpected:
        fail(f"faster-rcnn state: missing {missing}, unexpected {unexpected}")
    return cpu, card


def check_small_frcnn(nn, F, ops, resnet18, Momentum, L2Decay):
    """faster-rcnn's card-vs-CPU check at FRCNN_SMALL's size: in f64 and
    evaluation mode (as check_small_yolo), with the training targets
    computed all the same, the RPN and RoI samples bitwise on both devices
    (the RoIs are f32 after the proposals, so the f64 decodes' last bits do
    not reach them), the loss, every gradient and one Momentum step's moves
    by scaled_err; the planted one-pass NMS fault through
    generate_proposals on the chain; then the f32 serve on the CPU and the
    card's multiclass_nms on the CPU's decoded boxes and probabilities,
    bitwise.  Returns the readings by name."""
    import torch
    cfg = FRCNN_SMALL
    x, gts, classes, crowd, im_info = frcnn_batch(
        FRCNN_SMALL_B, cfg["img"], cfg["gt"], cfg["classes"], seed=3)
    x = torch.from_numpy(x)
    cpu, card = frcnn_small_pair(nn, F, resnet18)
    with torch.no_grad():
        cpu(x)                                        # running stats
        for mine, theirs in zip(card.buffers(), cpu.buffers()):
            mine.copy_(theirs)
    cpu.eval()
    card.eval()
    r = {}
    info_c = torch.from_numpy(im_info)
    dets_c, dec_c = frcnn_serve(ops, F, cpu, x, info_c, cfg)
    same = True
    for (boxes, p), want in zip(dec_c, dets_c):
        got = ops.multiclass_nms(boxes.cuda()[None], p.cuda()[None],
                                 return_index=True, **FRCNN_SERVE)
        same &= all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    r["serve_nms_bitwise"] = same
    r["serve_detections"] = sum(int(d[1].sum()) for d in dets_c)
    dets_g, _ = frcnn_serve(ops, F, card, x.cuda(), info_c.cuda(), cfg)
    r["serve_detections_card"] = sum(int(d[1].sum()) for d in dets_g)
    cpu64, card64 = cpu.double(), card.double()
    old = {n: p.detach().clone() for n, p in cpu64.named_parameters()}

    def step(m, dev):
        opt = Momentum(learning_rate=FRCNN_LR, momentum=0.9,
                       parameters=m.parameters(),
                       weight_decay=L2Decay(FRCNN_DECAY))
        loss, s = frcnn_loss(ops, F, m, x.to(dev, torch.float64), gts,
                             classes, crowd, info_c.to(dev), cfg)
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
        opt.step()
        opt.clear_grad()
        return loss.detach().cpu(), grads, {k: v.cpu() for k, v in s.items()}
    lc, gc, sc = step(cpu64, "cpu")
    lg, gg, sg = step(card64, "cuda")
    r["samples_bitwise"] = all(torch.equal(sg[k], sc[k]) for k in sc)
    r["rpn_fg_bg"] = [int((sc["tgt_label"] == 1).sum()),
                      int((sc["tgt_label"] == 0).sum())]
    r["roi_fg_bg"] = [int((sc["labels"] > 0).sum()),
                      int((sc["labels"] == 0).sum())]
    r["loss_f64"] = scaled_err(lg, lc)
    r["grad_f64"] = max(scaled_err(gg[n], gc[n]) for n in gc)
    r["moves_f64"] = moves_err(card64, cpu64, old, "faster-rcnn small")
    # the planted fault through the proposal stage: three anchors in a
    # chain at one level, zero deltas (the decode is exact)
    b, s = chain_case("cuda")
    args = (s.reshape(1, 1, 1, 3), torch.zeros(1, 4, 1, 3, device="cuda"),
            torch.tensor([[100.0, 100.0]], device="cuda"),
            b.reshape(1, 3, 1, 4), torch.ones(1, 3, 1, 4, device="cuda"),
            10, 10, 0.3, 0.0)
    r["chain_kept"] = len(ops.generate_proposals(*args)[0])
    with planted_nms(ops):
        r["chain_kept_fault"] = len(ops.generate_proposals(*args)[0])
    r["small_loss"] = float(lc)
    return r


def frcnn_train_phase(nn, F, ops, resnet18, resnet50, Momentum, L2Decay,
                      LinearWarmup, power):
    """faster-rcnn train: check_small_frcnn, then the composition at
    PaddleDetection's widths (resnet50, FPN 256, P2-P6, 81 classes), f32,
    Momentum(FRCNN_LR, 0.9) with L2Decay(FRCNN_DECAY) from the first steps
    of its LinearWarmup (0.1 x FRCNN_LR to FRCNN_LR over FRCNN_WARMUP
    steps), B=FRCNN_B at
    FRCNN_IMG, one warm-up then FRCNN_STEPS eager steps: ms a step,
    images/s, peak bytes, the device's busy ms and idle share of one more
    step; then one step with the stages timed on the host
    (StageClock) and each stage's fg / bg counts; every loss finite.
    Returns (the model, its last samples, the readings by name)."""
    import torch
    sv = check_small_frcnn(nn, F, ops, resnet18, Momentum, L2Decay)
    log(f"faster-rcnn small check (resnet18 backbone, P"
        f"{FRCNN_SMALL['stages'][0]}-P{FRCNN_SMALL['stages'][-1]}, B="
        f"{FRCNN_SMALL_B}, {FRCNN_SMALL['img'][0]}x{FRCNN_SMALL['img'][1]}, "
        f"{FRCNN_SMALL['classes'] - 1} classes) card vs CPU in f64, eval "
        f"mode: RPN / RoI samples bitwise {sv['samples_bitwise']} (RPN fg/bg "
        f"{sv['rpn_fg_bg']}, RoI fg/bg {sv['roi_fg_bg']}), loss "
        f"{sv['loss_f64']:.3g}, gradients {sv['grad_f64']:.3g}, Momentum "
        f"moves {sv['moves_f64']:.3g} (tol {TOL_F32:g}); the chain through "
        f"generate_proposals keeps {sv['chain_kept']} boxes, the planted "
        f"one-pass fault {sv['chain_kept_fault']}; f32 serve: card "
        f"multiclass_nms on the CPU's decoded boxes bitwise "
        f"{sv['serve_nms_bitwise']} ({sv['serve_detections']} detections; "
        f"{sv['serve_detections_card']} on the card end to end)")
    if not sv["samples_bitwise"] or not sv["serve_nms_bitwise"]:
        fail("the small faster-rcnn's samples or detections differ between "
             "the card and the CPU")
    if max(sv["loss_f64"], sv["grad_f64"], sv["moves_f64"]) > TOL_F32:
        fail("the small faster-rcnn on the card disagrees with the CPU")
    if sv["chain_kept"] != 2 or sv["chain_kept_fault"] != 1:
        fail("generate_proposals: the chain is not kept whole, or the "
             "planted one-pass fault does not cut it")
    cfg = FRCNN_FULL
    model = faster_rcnn_fpn(nn, F, resnet50, cfg)
    sched = LinearWarmup(FRCNN_LR, FRCNN_WARMUP, 0.1 * FRCNN_LR, FRCNN_LR)
    opt = Momentum(learning_rate=sched, momentum=0.9,
                   parameters=model.parameters(),
                   weight_decay=L2Decay(FRCNN_DECAY))
    x, gts, classes, crowd, im_info = frcnn_batch(
        FRCNN_B, cfg["img"], cfg["gt"], cfg["classes"])
    x = torch.as_tensor(x, device="cuda")
    gts = [torch.as_tensor(g, device="cuda") for g in gts]
    classes = [torch.as_tensor(c, device="cuda") for c in classes]
    info = torch.as_tensor(im_info, device="cuda")
    last = {}

    def step(clock=None):
        loss, s = frcnn_loss(ops, F, model, x, gts, classes, crowd, info,
                             cfg, clock)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        last.update(s)
        return loss.detach()
    torch.cuda.reset_peak_memory_stats()
    warm = float(step())
    losses, ms, host = eager_loop(step, FRCNN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    busy, traced = device_busy_ms(step)
    clock = StageClock()
    t0 = time.perf_counter()
    step(clock)
    torch.cuda.synchronize()
    clocked = (time.perf_counter() - t0) * 1e3
    counts = {"rpn_fg": int((last["tgt_label"] == 1).sum()),
              "rpn_bg": int((last["tgt_label"] == 0).sum()),
              "roi_fg": int((last["labels"] > 0).sum()),
              "roi_bg": int((last["labels"] == 0).sum())}
    n_anchors = int(last["anchors"])
    n_params = sum(p.numel() for p in model.parameters())
    log(f"faster-rcnn train: resnet50 + FPN {cfg['fpn']} (P2-P6) + RPN + "
        f"two FC of {cfg['fc']}, {n_params} parameters, {cfg['classes']} "
        f"classes, {n_anchors} anchors an image, f32, Momentum({FRCNN_LR:g}, "
        f"0.9) + L2Decay({FRCNN_DECAY:g}) in the first steps of a "
        f"{FRCNN_WARMUP}-step warmup from {0.1 * FRCNN_LR:g}, B={FRCNN_B} at "
        f"{cfg['img'][0]}x"
        f"{cfg['img'][1]}, {cfg['gt']} gt boxes an image, one warm-up then "
        f"{FRCNN_STEPS} eager steps: step {ms:.3f} ms (CUDA events; host "
        f"until step() returns {host:.3f} ms), {FRCNN_B / ms * 1e3:.3f} "
        f"images/s, max_memory_allocated {peak} bytes; one traced step: "
        f"device busy {busy:.3f} ms, idle share {1 - busy / ms:.3f} [{power}]"
        f"; losses {[warm] + losses}")
    log(f"faster-rcnn train: one step with its stages synchronized "
        f"({clocked:.3f} ms): host ms in the target stages (rpn_target_assign"
        f", generate_proposal_labels) {clock.ms['targets']:.3f}, in the "
        f"proposal stages (generate_proposals x5, collect_fpn_proposals, "
        f"distribute_fpn_proposals) {clock.ms['proposals']:.3f}; RPN fg / bg "
        f"{counts['rpn_fg']} / {counts['rpn_bg']}, RoI fg / bg "
        f"{counts['roi_fg']} / {counts['roi_bg']} [{power}]")
    if not all(math.isfinite(v) for v in [warm] + losses):
        fail("a faster-rcnn training loss is not finite")
    if n_anchors != FRCNN_ANCHORS:
        fail(f"faster-rcnn: {n_anchors} anchors an image, not "
             f"{FRCNN_ANCHORS}")
    del opt
    torch.cuda.empty_cache()
    return model, last, (gts, classes), {
        "step_ms": ms, "images_per_s": FRCNN_B / ms * 1e3, "host_ms": host,
        "peak_bytes": peak, "busy_ms": busy, "traced_wall_ms": traced,
        "idle_share": 1 - busy / ms, "losses": [warm] + losses,
        "params": n_params, "clocked_step_ms": clocked,
        "target_stages_host_ms": clock.ms["targets"],
        "proposal_stages_host_ms": clock.ms["proposals"], **counts,
        "small": sv}


def frcnn_serve_phase(ops, F, model, power):
    """faster-rcnn serve: the trained composition in evaluation mode, B=
    FRCNN_B at FRCNN_IMG: ms a batch, images/s, the host ms of the proposal
    stage and of the NMS (one request with them synchronized); the
    detections of each image within keep_top_k, finite, each class's kept
    boxes pairwise at most the NMS threshold."""
    import torch
    cfg = FRCNN_FULL
    model.eval()
    x = torch.as_tensor(frcnn_batch(FRCNN_B, cfg["img"], cfg["gt"],
                                    cfg["classes"], seed=7)[0],
                        device="cuda")
    info = torch.tensor([[*cfg["img"], 1.0]] * FRCNN_B, device="cuda")
    dets, _ = frcnn_serve(ops, F, model, x, info, cfg)
    ms = wall_ms(lambda: frcnn_serve(ops, F, model, x, info, cfg), reps=3)
    clock = StageClock()
    clock.ms["nms"] = 0.0
    frcnn_serve(ops, F, model, x, info, cfg, clock, clock)
    per_img = [int(d[1].sum()) for d in dets]
    for out, _, _ in dets:
        if len(out) > FRCNN_SERVE["keep_top_k"] or not bool(
                torch.isfinite(out).all()):
            fail("faster-rcnn serve: too many or non-finite detections")
        worst = nms_overlap(ops, out)
        if worst > FRCNN_SERVE["nms_threshold"]:
            fail(f"faster-rcnn serve: two kept boxes of a class overlap "
                 f"{worst:.3g}")
    log(f"faster-rcnn serve: eval(), B={FRCNN_B} at {cfg['img'][0]}x"
        f"{cfg['img'][1]}, proposals {cfg['test_proposals'][0]} / "
        f"{cfg['test_proposals'][1]} a level, {FRCNN_COLLECT} an image, "
        f"box_decoder_and_assign, box_clip, multiclass_nms (background 0, "
        f"{FRCNN_SERVE['score_threshold']:g}, NMS "
        f"{FRCNN_SERVE['nms_threshold']:g}, keep {FRCNN_SERVE['keep_top_k']})"
        f": {ms:.3f} ms a batch (host to a synchronize), "
        f"{FRCNN_B / ms * 1e3:.3f} images/s; one request synchronized: "
        f"proposal stage {clock.ms['proposals']:.3f} ms, NMS "
        f"{clock.ms['nms']:.3f} ms; detections an image {per_img} [{power}]")
    return {"batch_ms": ms, "images_per_s": FRCNN_B / ms * 1e3,
            "proposal_stage_ms": clock.ms["proposals"],
            "nms_ms": clock.ms["nms"], "detections": per_img}


def nms_overlap(ops, out):
    """The largest IoU between two rows of one class of a detection output
    (D, 6) (0 without a pair)."""
    worst = 0.0
    for c in out[:, 0].unique():
        b = out[out[:, 0] == c, 2:]
        if len(b) > 1:
            iou = ops.box_iou(b, b).triu(1)
            worst = max(worst, float(iou.max()))
    return worst


def ssd_priors(ops):
    """SSD300's 8,732 priors (ssd_vgg16_300_240e_voc: six maps, min and max
    sizes, ratios, steps, flipped, clipped), (P, 4) normalised xyxy."""
    import torch
    img = torch.zeros(1, 3, 300, 300)
    return torch.cat([ops.prior_box(torch.zeros(1, 1, m, m), img, [lo], [hi],
                                    list(ar), flip=True, clip=True,
                                    steps=(float(st), float(st)))[0]
                      .reshape(-1, 4) for m, lo, hi, ar, st in SSD_MAPS])


def ssd_targets(ops, priors, gt, lab, loss):
    """SSD's target stage of a batch: iou_similarity, then per image
    bipartite_match (per_prediction, 0.5); mine_hard_examples (ratio 3)
    and target_assign of the locations and of the labels with the mined
    negatives."""
    import torch
    m, d = zip(*(ops.bipartite_match(ops.iou_similarity(g, priors),
                                     "per_prediction", 0.5) for g in gt))
    mi = torch.stack(m)
    neg, mi2 = ops.mine_hard_examples(loss, mi, 3.0)
    loc, loc_w = ops.target_assign(gt, mi)
    cls, cls_w = ops.target_assign(lab, mi, neg, 0)
    return [mi, torch.stack(d), mi2, loc, loc_w, cls, cls_w] + list(neg)


def retina_anchors(ops):
    """RetinaNet's 9 anchors a place (3 octave scales from 4 x the stride,
    ratios 0.5, 1, 2) on P3-P7 of an RETINA_IMG image: [(A_l, 4)]."""
    import torch
    h, w = RETINA_IMG
    out = []
    for st in RETINA_STRIDES:
        feat = torch.zeros(1, 1, -(-h // st), -(-w // st))
        out.append(ops.anchor_generator(
            feat, [4.0 * st * 2 ** (k / 3) for k in range(3)],
            [0.5, 1.0, 2.0], stride=(float(st), float(st)))[0].reshape(-1, 4))
    return out


def east_map(seed=0):
    """EAST's per-pixel boxes of a 512x512 image at stride 4 (128 x 128 =
    16,384 boxes in raster order): pixels inside one of 12 text boxes
    predict it (jittered by N(0, 1) pixels) with scores U(0.6, 1), the
    others a small box below the 0.05 threshold."""
    import numpy as np
    r = np.random.default_rng(seed)
    n = EAST_MAP
    wh = r.uniform([60, 14], [220, 40], (12, 2))
    xy = r.uniform(0, 1, (12, 2)) * (4 * n - wh)
    text = np.concatenate([xy, xy + wh], 1)
    cy, cx = np.meshgrid(np.arange(n) * 4 + 2.0, np.arange(n) * 4 + 2.0,
                         indexing="ij")
    cx, cy = cx.reshape(-1), cy.reshape(-1)
    boxes = np.stack([cx - 2, cy - 2, cx + 2, cy + 2], 1)
    scores = r.uniform(0, 0.04, n * n)
    for t in text:
        inside = (cx >= t[0]) & (cx <= t[2]) & (cy >= t[1]) & (cy <= t[3])
        boxes[inside] = t + r.normal(0, 1, (int(inside.sum()), 4))
        scores[inside] = r.uniform(0.6, 1, int(inside.sum()))
    return boxes.astype(np.float32), scores.astype(np.float32)


def fots_quads(seed=0):
    """PERSP's text quads: centres in a 640x640 image, w 60-200, h 16-40
    pixels, turned by up to 30 degrees, corners clockwise from the top
    left: (R, 8) f32."""
    import numpy as np
    r = np.random.default_rng(seed)
    n = PERSP["rois"]
    c = r.uniform(100, 540, (n, 2))
    wh = r.uniform([60, 16], [200, 40], (n, 2))
    a = r.uniform(-np.pi / 6, np.pi / 6, n)
    corner = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) / 2
    pts = corner[None] * wh[:, None]
    rot = np.stack([np.cos(a), -np.sin(a), np.sin(a), np.cos(a)],
                   1).reshape(n, 2, 2)
    return (np.einsum("nij,nkj->nki", rot, pts) + c[:, None]).reshape(
        n, 8).astype(np.float32)


def polygons_in(box, r, k=10):
    """A star-shaped polygon of k vertices inside ``box``."""
    import numpy as np
    x1, y1, x2, y2 = (float(v) for v in box)
    a = np.sort(r.uniform(0, 2 * np.pi, k))
    rad = r.uniform(0.5, 1.0, k)
    return [np.stack([(x1 + x2) / 2 + rad * (x2 - x1) / 2 * np.cos(a),
                      (y1 + y2) / 2 + rad * (y2 - y1) / 2 * np.sin(a)],
                     1).astype(np.float32)]


def same_outputs(a, b):
    """Bitwise equality of two (nested) outputs, the first on the card."""
    import torch
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_outputs(x, y)
                                        for x, y in zip(a, b))
    return a.device.type == "cuda" and torch.equal(a.cpu(), b)


def det_tail_phase(ops, power, frcnn_last, frcnn_gts):
    """det-tail: each function of vision.ops' second half that phases 32,
    34 and 35 do not run, card against CPU on identical inputs (indices,
    labels and kept sets bitwise, values and gradients within TOL_F32),
    timed at the shape of the model it serves: SSD300's target stage,
    RetinaNet R50-FPN's targets and detection output, Mask R-CNN's mask
    targets over faster-rcnn's last samples, EAST's locality-aware NMS,
    FOTS's RoI perspective transform and Faster R-CNN's
    box_decoder_and_assign (forward and backward).  Returns the readings
    by name."""
    import numpy as np
    import torch
    rows = {}
    r = np.random.default_rng(36)

    def held(name, same, ms, what, extra="", how="host to a synchronize"):
        rows[name] = {"ms": ms, "card_vs_cpu": same}
        log(f"det-tail: {name} at {what}: card vs CPU {same}; {ms:.3f} ms a "
            f"call ({how}){extra} [{power}]")
    # SSD300 (8,732 priors, 21 VOC classes), B=8, 20 gt boxes an image
    priors = ssd_priors(ops)
    if len(priors) != SSD_PRIORS:
        fail(f"SSD300 has {len(priors)} priors, not {SSD_PRIORS}")
    xy = r.uniform(0, 0.7, (SSD_B, SSD_GT, 2))
    gt = np.concatenate([xy, xy + r.uniform(0.05, 0.3, (SSD_B, SSD_GT, 2))],
                        2).astype(np.float32)
    lab = r.integers(1, SSD_CLASSES, (SSD_B, SSD_GT, 1)).astype(np.int32)
    loss = r.random((SSD_B, SSD_PRIORS)).astype(np.float32)
    cpu = [priors, torch.from_numpy(gt), torch.from_numpy(lab),
           torch.from_numpy(loss)]
    gpu = [t.cuda() for t in cpu]
    want = ssd_targets(ops, *cpu)
    got = ssd_targets(ops, *gpu)
    held("ssd_targets", same_outputs(got, want),
         wall_ms(lambda: ssd_targets(ops, *gpu)),
         f"SSD300 ({SSD_PRIORS} priors, B={SSD_B}, {SSD_GT} gt boxes an "
         "image): iou_similarity, bipartite_match x8, mine_hard_examples, "
         "target_assign x2", f"; {int((want[0] >= 0).sum())} matched priors")
    # RetinaNet R50-FPN at 800x1344: 201,600 anchors
    anchors = retina_anchors(ops)
    an_all = torch.cat(anchors)
    if len(an_all) != RETINA_ANCHORS:
        fail(f"RetinaNet has {len(an_all)} anchors, not {RETINA_ANCHORS}")
    gts, labels = frcnn_gts
    gts_c = [g.cpu() for g in gts]
    labels_c = [c.cpu() for c in labels]
    want = ops.retinanet_target_assign(an_all, gts_c, labels_c, None, 0.5,
                                       0.4)
    an_g = an_all.cuda()
    got = ops.retinanet_target_assign(an_g, gts, labels, None, 0.5, 0.4)
    same = (same_outputs([got[i] for i in (0, 1, 3, 4, 5)],
                         [want[i] for i in (0, 1, 3, 4, 5)])
            and scaled_err(got[2].cpu(), want[2]) <= TOL_F32)
    held("retinanet_target_assign", same, wall_ms(
        lambda: ops.retinanet_target_assign(an_g, gts, labels, None, 0.5,
                                            0.4)),
         f"RetinaNet R50-FPN ({RETINA_ANCHORS} anchors, B={len(gts)}, 0.5 / "
         "0.4)", f"; fg {got[5].tolist()}")
    deltas = [torch.from_numpy(r.normal(0, 0.1, (len(a), 4)).astype(
        np.float32)) for a in anchors]
    scores = [torch.sigmoid(torch.from_numpy(r.normal(
        -4, 1, (len(a), RETINA_CLASSES)).astype(np.float32)))
        for a in anchors]
    info = torch.tensor([[*RETINA_IMG, 1.0]])
    zeros = [torch.zeros_like(d) for d in deltas]
    want = ops.retinanet_detection_output(zeros, scores, anchors, info,
                                          **RETINA_OUT)
    sc_g = [s.cuda() for s in scores]
    an_l = [a.cuda() for a in anchors]
    got = ops.retinanet_detection_output([z.cuda() for z in zeros], sc_g,
                                         an_l, info.cuda(), **RETINA_OUT)
    same = same_outputs(got, want)
    dl_g = [d.cuda() for d in deltas]
    out = ops.retinanet_detection_output(dl_g, sc_g, an_l, info.cuda(),
                                         **RETINA_OUT)
    worst = nms_overlap(ops, out)
    sane = (len(out) <= RETINA_OUT["keep_top_k"]
            and bool(torch.isfinite(out).all())
            and worst <= RETINA_OUT["nms_threshold"]
            and bool((out[1:, 1] <= out[:-1, 1]).all()))
    held("retinanet_detection_output", same and sane, wall_ms(
        lambda: ops.retinanet_detection_output(dl_g, sc_g, an_l, info.cuda(),
                                               **RETINA_OUT)),
         f"RetinaNet R50-FPN (P3-P7, {RETINA_CLASSES} classes, 0.05, 1,000 a "
         "level, NMS 0.5, 100 kept)",
         f"; bitwise on zero deltas (exact decode), and with N(0, 0.1) "
         f"deltas {len(out)} detections, scores falling, largest same-class "
         f"IoU {worst:.3g}")
    # Mask R-CNN's mask targets over faster-rcnn's last sampled RoIs
    nums = frcnn_last["nums"].tolist()
    rois = list(frcnn_last["rois"].split(nums))
    labs = list(frcnn_last["labels"].split(nums))
    segms = [[polygons_in(b, r) for b in g.cpu().numpy()] for g in gts]
    crowd = [np.zeros(len(g), bool) for g in gts]

    def masks(rs, ls, cls):
        return ops.generate_mask_labels(None, cls, crowd, segms, rs, ls,
                                        num_classes=FRCNN_FULL["classes"],
                                        resolution=MASK_RES)
    want = masks([t.cpu() for t in rois], [t.cpu() for t in labs], labels_c)
    got = masks(rois, labs, labels)
    held("generate_mask_labels", same_outputs(got, want),
         wall_ms(lambda: masks(rois, labs, labels)),
         f"Mask R-CNN (resolution {MASK_RES}, {FRCNN_FULL['classes']} "
         f"classes, {sum(nums)} sampled RoIs)",
         f"; {len(want[0])} fg RoIs, mask_int32 {tuple(want[2].shape)}")
    # EAST's locality-aware NMS on a 512x512 image's 128x128 map
    b, s = (torch.from_numpy(a) for a in east_map())
    want = ops.locality_aware_nms(b, s)
    bg, sg = b.cuda(), s.cuda()
    got = ops.locality_aware_nms(bg, sg)
    held("locality_aware_nms", same_outputs(got, want),
         wall_ms(lambda: ops.locality_aware_nms(bg, sg)),
         f"EAST ({EAST_MAP}x{EAST_MAP} = {EAST_MAP ** 2} boxes, defaults)",
         f"; {len(want)} boxes kept")
    # FOTS's RoI rotate: text quads warped to 8 x 64 from the 1/4 map
    x = torch.from_numpy(r.standard_normal(PERSP["map"]).astype(np.float32))
    quads = torch.from_numpy(fots_quads())
    th, tw = PERSP["out"]
    dy = torch.from_numpy(r.standard_normal(
        (len(quads), PERSP["map"][1], th, tw)).astype(np.float32))

    def warp(xx, q, g):
        xx = xx.detach().requires_grad_()
        out = ops.roi_perspective_transform(xx, q, th, tw, PERSP["scale"])
        out.backward(g)
        return out.detach(), xx.grad
    want = warp(x, quads, dy)
    xg, qg, dg = x.cuda(), quads.cuda(), dy.cuda()
    got = warp(xg, qg, dg)
    errs = [scaled_err(a.cpu(), b_) for a, b_ in zip(got, want)]
    held("roi_perspective_transform", max(errs) <= TOL_F32,
         wall_ms(lambda: warp(xg, qg, dg)),
         f"FOTS's RoIRotate ({PERSP['rois']} quads, map "
         f"{'x'.join(map(str, PERSP['map']))}, {th}x{tw}, scale "
         f"{PERSP['scale']:g}), forward + backward",
         f"; values {errs[0]:.3g}, gradients {errs[1]:.3g} (tol "
         f"{TOL_F32:g})")
    # box_decoder_and_assign at faster-rcnn serve's 2,000 RoIs, 81 classes
    n, c = DEC_ROIS, FRCNN_FULL["classes"]
    pb = torch.from_numpy(det_rois(1, n))
    pbv = torch.tensor(FRCNN_REG_W).expand(n, 4).contiguous()
    tb = torch.from_numpy(r.normal(0, 1, (n, 4 * c)).astype(np.float32))
    sc = torch.softmax(torch.from_numpy(r.normal(0, 1, (n, c)).astype(
        np.float32)), -1)
    w = [torch.from_numpy(r.standard_normal(s_).astype(np.float32))
         for s_ in ((n, 4 * c), (n, 4))]

    def dec(ins, ws):
        ins = [t.detach().requires_grad_() for t in ins]
        outs = ops.box_decoder_and_assign(*ins)
        sum((o * wi).sum() for o, wi in zip(outs, ws)).backward()
        return [o.detach() for o in outs] + [t.grad for t in ins[:3]]
    want = dec([pb, pbv, tb, sc], w)
    gins, gw = [t.cuda() for t in (pb, pbv, tb, sc)], [t.cuda() for t in w]
    got = dec(gins, gw)
    errs = [scaled_err(a.cpu(), b_) for a, b_ in zip(got, want)]
    ms = cuda_ms(lambda: dec(gins, gw), reps=5, warmup=1)
    held("box_decoder_and_assign", max(errs) <= TOL_F32, ms,
         f"Faster R-CNN serve ({n} RoIs, {c} classes), forward + backward",
         f"; values and gradients {max(errs):.3g} (tol {TOL_F32:g})",
         how="CUDA events")
    bad = [k for k, v in rows.items() if not v["card_vs_cpu"]]
    if bad:
        fail("det-tail: the card disagrees with the CPU in " + ", ".join(bad))
    return rows


def outputs_err(card, cpu):
    """(True if every integer and bool output is bitwise the CPU's and
    every dtype and shape agrees, the largest scaled error of the float
    outputs) of two (nested) outputs, the first from the card.
    Non-finite float entries must sit in the same places with the same
    values; finite ones are measured as grad_err measures."""
    import torch
    if isinstance(card, (list, tuple)):
        if not isinstance(cpu, (list, tuple)) or len(card) != len(cpu):
            return False, float("inf")
        pairs = [outputs_err(a, b) for a, b in zip(card, cpu)]
        return all(p[0] for p in pairs), max((p[1] for p in pairs),
                                             default=0.0)
    a, b = card.detach().cpu(), cpu.detach()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False, float("inf")
    if not (a.is_floating_point() or a.is_complex()):
        return bool(torch.equal(a, b)), 0.0
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(
            a[~fa].nan_to_num(nan=0.0), b[~fb].nan_to_num(nan=0.0)):
        return False, float("inf")
    if not bool(fa.any()):
        return True, 0.0
    a, b = a[fa], b[fb]
    rms = b.pow(2).mean().sqrt()
    return True, float(((a - b).abs() / (b.abs() + rms).clamp_min(1e-30))
                       .max())


def eval_nll(T, lg, lab):
    """Next-token NLL of logits lg (N, V) at labels lab (N, 1): logsumexp
    minus the label's logit, its mean and exp."""
    lse = T.logsumexp(lg, axis=-1)
    gold = T.index_sample(lg, lab)[:, 0]
    nll = T.mean(T.subtract(lse, gold))
    return {"lse": lse, "gold": gold, "nll": nll, "ppl": T.exp(nll)}


def eval_accuracy(T, lg, lab):
    pred = T.argmax(lg, axis=-1)
    return {"acc1": T.accuracy(lg, lab, k=1),
            "acc5": T.accuracy(lg, lab, k=5), "pred": pred,
            "agree": T.mean(T.equal(pred, lab[:, 0]))}


def eval_topk(T, lg):
    return {"topk": T.topk(lg, k=EVAL_TOPK)}


def eval_nucleus(T, lg, lse):
    """The nucleus cut at EVAL_P: each row's probabilities in descending
    order (its argsort), their running sum, and where it passes EVAL_P."""
    order = T.argsort(lg, axis=-1, descending=True)
    probs = T.exp(T.subtract(lg, lse[:, None]))
    cum = T.cumsum(T.index_sample(probs, order), axis=1)
    cut = T.searchsorted(cum, T.full_like(lse[:, None], EVAL_P))
    return {"order": order, "cum": cum, "cut": cut}


def eval_quantiles(T, values):
    return {"q": T.quantile(values, list(EVAL_Q)), "median": T.median(values)}


def eval_all(T, lg, lab, values):
    out = eval_nll(T, lg, lab)
    out.update(eval_accuracy(T, lg, lab))
    out.update(eval_topk(T, lg))
    out.update(eval_nucleus(T, lg, out["lse"]))
    out.update(eval_quantiles(T, values))
    return out


def final_hidden(model, ids):
    """GPT's final-LN hidden states (B, S, H), the head's input."""
    from paddle_tpu_torch.models.gpt import _PARAM_ORDER, _gpt_forward
    return _gpt_forward(model.config, dict(zip(_PARAM_ORDER,
                                               model._param_list())),
                        model._ids(ids), features_only=True)


def gpt_eval_phase(T, model, cfg, gpt_loss, set_flags, gpt_forward, power):
    """gpt-eval (37) of ``model``, phase 3's GPT-2 345M in bf16.  Returns
    (the phase's row, the final hidden states (B, S, H) bf16, the
    embedding wte in f32, the token ids)."""
    import numpy as np
    import torch
    torch.cuda.reset_peak_memory_stats()
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")
    with torch.inference_mode():
        set_flags({"gpt_fused_ce": False})
        loss_ref = float(gpt_loss(model, ids, ids))
        lg = model(ids)[:, :-1].float().reshape(-1, cfg.vocab_size)
        hidden = gpt_forward(model, ids)
    lab = ids[:, 1:].reshape(-1, 1)
    values = torch.cat([p.detach().float().abs().reshape(-1)
                        for p in model.parameters()])
    wte = model.wte.detach().float()
    del model
    torch.cuda.empty_cache()
    n, v = lg.shape
    log(f"gpt-eval: GPT-2 345M (bf16) logits {n} x {v} f32 "
        f"({lg.numel() * 4 / 1e9:.2f} GB), {values.numel()} parameter "
        f"values")
    if values.numel() != 354_871_296:
        fail(f"GPT-2 345M has {values.numel()} parameter values")
    with torch.inference_mode():
        out = eval_all(T, lg, lab, values)
        # card against a CPU copy: 64 rows, 2**20 parameter values
        rows = {"lg": lg[:CPU_ROWS], "lab": lab[:CPU_ROWS],
                "values": values[:CPU_PARAMS]}
        card = eval_all(T, *rows.values())
        cpu = eval_all(T, *(t.cpu() for t in rows.values()))
        cpu["cut"] = T.searchsorted(card["cum"].cpu(), T.full_like(
            cpu["lse"][:, None], EVAL_P))
        s_full = torch.sort(values).values
    errs = {k: outputs_err(card[k], cpu[k]) for k in card}
    bad = [k for k, (same, err) in errs.items()
           if not same or err > TOL_F32]
    log(f"gpt-eval: card vs CPU ({CPU_ROWS} rows, {CPU_PARAMS} parameter "
        f"values): indices and counts bitwise, values max scaled err "
        f"{max(e for _, e in errs.values()):.3g} (tol {TOL_F32:g})"
        + (f"; differ: {bad}" if bad else ""))
    if bad:
        fail(f"gpt-eval card vs CPU differ in {bad}")
    # invariants at the full shape
    nll, ppl = float(out["nll"]), float(out["ppl"])
    acc1, acc5, agree = (float(out[k]) for k in ("acc1", "acc5", "agree"))
    topv, topi = out["topk"]
    desc = torch.sort(lg, dim=-1, descending=True).values[:, :EVAL_TOPK]
    q = out["q"].tolist()
    cnt = values.numel()
    q_ok = all(float(s_full[math.floor(qq * (cnt - 1))]) <= got
               <= float(s_full[math.ceil(qq * (cnt - 1))])
               for qq, got in zip(EVAL_Q, q))
    mid = float((s_full[(cnt - 1) // 2] + s_full[cnt // 2]) * 0.5)
    cut = out["cut"]
    log(f"gpt-eval: NLL {nll:.6f} (gpt_loss {loss_ref:.6f}, ln V "
        f"{math.log(v):.6f}), perplexity {ppl:.1f}; accuracy@1 {acc1:.6f} "
        f"@5 {acc5:.6f}, argmax agreement {agree:.6f}; nucleus p={EVAL_P}: "
        f"{float(cut.float().mean()) + 1:.1f} tokens a row on average; "
        f"|w| quantiles {dict(zip(EVAL_Q, q))}, median {float(out['median'])}"
        f" (the sorted midpoint {mid})")
    if abs(nll - loss_ref) > TOL_F32 or abs(nll - math.log(v)) > 1.0 or \
            not math.isfinite(ppl):
        fail("gpt-eval NLL disagrees with gpt_loss or is not near ln V")
    if acc1 != agree or not 0 <= acc1 <= acc5 <= 1:
        fail("accuracy@1 is not the argmax agreement, or @5 below @1")
    if not torch.equal(topv, desc) or not torch.equal(
            lg.gather(1, topi), topv):
        fail("topk values are not the sorted logits")
    if float((out["cum"][:, -1] - 1).abs().max()) > 1e-3 or \
            int(cut.min()) < 0 or int(cut.max()) > v:
        fail("the nucleus's running sums do not end at 1")
    if not q_ok or float(out["median"]) != mid:
        fail("a quantile lies outside the sorted values it interpolates")
    lg64 = rows["lg"]
    # planted faults, told apart by the same check.  torch.topk's order
    # among ties is not documented: on the CPU it is not lax.top_k's (the
    # fault is rejected); the card's result is read and reported
    naive = {
        "torch.topk (CPU)": (torch.topk(lg64.cpu(), EVAL_TOPK).indices,
                             cpu["topk"][1]),
        "torch.argsort(descending=True, stable=True)": (
            torch.argsort(lg64, dim=-1, descending=True, stable=True),
            cpu["order"]),
        "torch.median": (torch.median(torch.tensor(
            [1.0, 2.0, 3.0, 4.0], device="cuda")),
            T.median(torch.tensor([1.0, 2.0, 3.0, 4.0])))}
    caught = {k: not (s and e <= TOL_F32)
              for k, (s, e) in ((k, outputs_err(*p))
                                for k, p in naive.items())}
    with torch.inference_mode():
        card_topk_rows = int((torch.topk(lg, EVAL_TOPK).indices
                              != out["topk"][1]).any(-1).sum())
    ties = int(sum(int((r[:EVAL_TOPK + 1].diff() == 0).any())
                   for r in torch.sort(lg64, dim=-1,
                                       descending=True).values))
    log(f"gpt-eval: planted faults told apart {caught} ({ties} of "
        f"{CPU_ROWS} rows tie within their top {EVAL_TOPK + 1}); "
        f"torch.topk on the card orders ties otherwise than lax.top_k in "
        f"{card_topk_rows} of {n} rows")
    if not all(caught.values()):
        fail(f"a naive call passes the gpt-eval check: {caught}")
    # ms of each call group at the full shape, after a warm-up
    groups = {"nll": lambda: eval_nll(T, lg, lab),
              "accuracy": lambda: eval_accuracy(T, lg, lab),
              "topk": lambda: eval_topk(T, lg),
              "nucleus": lambda: eval_nucleus(T, lg, out["lse"]),
              "quantiles": lambda: eval_quantiles(T, values)}
    with torch.inference_mode():
        ms = {k: cuda_ms(fn, reps=3, warmup=1) for k, fn in groups.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"gpt-eval: ms a call group at the full shape {ms}; "
        f"{n / sum(ms[k] for k in ('nll', 'accuracy')) * 1e3:.0f} scored "
        f"tokens/s (nll + accuracy); peak {peak} bytes [{power}]")
    row = {"ms": ms, "peak_bytes": peak, "nll": nll,
           "gpt_loss": loss_ref, "perplexity": ppl, "accuracy1": acc1,
           "accuracy5": acc5, "quantiles": q, "median": float(out["median"]),
           "cpu_max_scaled_err": max(e for _, e in errs.values()),
           "planted_faults_caught": caught, "tied_rows": ties,
           "card_topk_rows_differing": card_topk_rows}
    del lg, values, s_full, out, card
    torch.cuda.empty_cache()
    return row, hidden, wte, ids


def ridge_system(T, X, Y, scale):
    """A = X^T X / N + lambda I with lambda = scale * trace(X^T X / N) /
    H, and B = X^T Y / N."""
    n, h = X.shape
    G = T.divide(T.matmul(X, X, transpose_x=True), n)
    lam = T.multiply(scale / h, T.trace(G))
    A = T.add(G, T.multiply(lam, T.eye(h, device=X.device)))
    return G, A, T.divide(T.matmul(X, Y, transpose_x=True), n), lam


def ridge_solutions(T, X, Y, A, B, lam):
    """The probe's six solutions of A W = B: through the Cholesky factor
    (cholesky_solve, and two triangular solves), solve, inverse, lstsq (of
    X stacked on sqrt(lambda) I, and Y on zeros: its normal equations are
    A W = B) and pinv."""
    import torch
    n, h = X.shape
    xa = torch.cat([T.divide(X, math.sqrt(n)),
                    T.multiply(T.sqrt(lam), T.eye(h, device=X.device))])
    ya = torch.cat([T.divide(Y, math.sqrt(n)),
                    T.zeros([h, Y.shape[1]], device=X.device)])
    low = T.cholesky(A)
    return {"cholesky": T.cholesky_solve(B, low),
            "triangular": T.triangular_solve(
                low, T.triangular_solve(low, B, upper=False), upper=False,
                transpose=True),
            "solve": T.solve(A, B),
            "inverse": T.matmul(T.inverse(A), B),
            "lstsq": T.lstsq(xa, ya)[0],
            "pinv": T.matmul(T.pinv(A), B)}


def rel(a, b):
    """||a - b|| / ||b||, Frobenius."""
    import torch
    return float(torch.linalg.norm((a - b).double())
                 / torch.linalg.norm(b.double()).clamp_min(1e-300))


def ortho_err(q):
    import torch
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    return float((q.transpose(-1, -2) @ q - eye).abs().max())


def lu_err(lu, piv, a):
    """||A[perm] - L U|| / ||A|| from packed LU and 0-based pivots
    (LAPACK's row swaps, applied in order); inf if a pivot is out of
    range."""
    import torch
    h = a.shape[0]
    swaps = piv.tolist()
    if min(swaps) < 0 or max(swaps) >= h:
        return float("inf")
    perm = list(range(h))
    for i, p in enumerate(swaps):
        perm[i], perm[p] = perm[p], perm[i]
    low = torch.tril(lu, -1) + torch.eye(h, dtype=lu.dtype, device=lu.device)
    return rel(low @ torch.triu(lu), a[perm])


def breadth_env(T, x, ids):
    """The breadth cases' inputs from GPT-2's activation x (f32) and the
    token ids, on x's device."""
    import numpy as np
    import torch
    dev = x.device
    y = x.flip(-1)
    special = x.clone()
    special[..., 0], special[..., 1], special[..., 2] = (
        float("inf"), float("-inf"), float("nan"))
    return {"dev": str(dev), "x": x, "xb": x.to(torch.bfloat16), "y": y,
            "yb": y.to(torch.bfloat16), "pos": x.abs() + 0.1,
            "unit": torch.tanh(x) * 0.9, "ge1": x.abs() + 1.1,
            "mask": x > 0, "special": special, "ids": ids,
            "row": x[0, 0], "mat": x[0, :64, :64], "x3": x[..., :3],
            "y3": y[..., :3], "host": np.random.default_rng(38)
            .standard_normal(1024), "gather": torch.tensor(
                [0, 5, -1, 2000, 1023], device=dev),
            "i32": (x * 4).to(torch.int32)}


def tensor_breadth_cases(T, Constant):
    """(group, names, fn(env)) for every name of the tensor library that
    phases 37 and 38's probe do not run."""
    import torch
    unary = ("exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
             "rsqrt", "square", "abs", "sign", "ceil", "floor", "round",
             "trunc", "frac", "sin", "cos", "tan", "asin", "acos", "atan",
             "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "erf",
             "erfinv", "reciprocal", "neg", "digamma", "lgamma", "sigmoid",
             "conj", "angle", "deg2rad", "rad2deg")
    domain = {"log": "pos", "log2": "pos", "log10": "pos", "log1p": "pos",
              "sqrt": "pos", "rsqrt": "pos", "reciprocal": "pos",
              "digamma": "pos", "lgamma": "pos", "tan": "unit",
              "asin": "unit", "acos": "unit", "atanh": "unit",
              "erfinv": "unit", "acosh": "ge1"}
    cases = []
    for n in unary:
        d = domain.get(n, "x")
        cases.append(("elementwise_f32", (n,),
                      lambda e, n=n, d=d: getattr(T, n)(e[d])))
        cases.append(("elementwise_bf16", (n,),
                      lambda e, n=n, d=d: getattr(T, n)(
                          e[d].to(torch.bfloat16))))
    for n in ("add", "subtract", "multiply", "divide", "pow", "maximum",
              "minimum", "fmax", "fmin", "atan2", "hypot", "logaddexp",
              "divide_no_nan", "floor_divide", "remainder", "mod",
              "floor_mod"):
        second = "pos" if n in ("pow",) else "y"
        cases.append(("elementwise_f32", (n,),
                      lambda e, n=n, s=second: getattr(T, n)(e["x"], e[s])))
        cases.append(("elementwise_bf16", (n,),
                      lambda e, n=n, s=second: getattr(T, n)(
                          e["xb"], e[s].to(torch.bfloat16))))
    cases += [
        ("elementwise_int", ("floor_divide", "remainder", "bitwise_and",
                             "bitwise_or", "bitwise_xor", "bitwise_not"),
         lambda e: (T.floor_divide(e["ids"], 7), T.remainder(e["ids"], 7),
                    T.bitwise_and(e["ids"], 255), T.bitwise_or(e["ids"], 3),
                    T.bitwise_xor(e["ids"], e["ids"].flip(-1)),
                    T.bitwise_not(e["ids"]))),
        ("elementwise_f32", ("scale", "clip", "lerp", "stanh"),
         lambda e: (T.scale(e["x"], 2.0, 0.5), T.clip(e["x"], -1.0, 1.0),
                    T.lerp(e["x"], e["y"], 0.3), T.stanh(e["x"]))),
        ("elementwise_f32", ("cross", "dot", "isclose", "allclose",
                             "equal_all", "diff"),
         lambda e: (T.cross(e["x3"], e["y3"]), T.dot(e["x"], e["y"]),
                    T.isclose(e["x"], T.add(e["x"], 1e-6)),
                    T.allclose(e["x"], e["x"].clone()),
                    T.equal_all(e["x"], e["y"]), T.diff(e["x"], axis=-1))),
        ("elementwise_f32", ("isfinite", "isinf", "isnan"),
         lambda e: (T.isfinite(e["special"]), T.isinf(e["special"]),
                    T.isnan(e["special"]))),
        ("elementwise_f32", ("increment",),
         lambda e: T.increment(e["x"].clone(), 1.0)),
        ("matrix", ("addmm", "multiplex", "kron", "inner", "outer", "bmm",
                    "mm", "mv"),
         lambda e: (T.addmm(e["mat"], e["mat"], e["mat"], 0.5, 2.0),
                    T.multiplex([e["mat"], T.neg(e["mat"])],
                                T.remainder(T.arange(
                                    64, device=e["dev"]), 2)[:, None]),
                    T.kron(e["mat"][:8, :8], e["mat"][:8, :8]),
                    T.inner(e["mat"], e["mat"]),
                    T.outer(e["row"], e["row"]),
                    T.bmm(e["x"][:, :64, :64], e["x"][:, :64, :64]),
                    T.mm(e["mat"], e["mat"]), T.mv(e["mat"], e["mat"][0]))),
        ("matrix", ("dist", "einsum", "add_n"),
         lambda e: (T.dist(e["x"], e["y"]),
                    T.einsum("bsh,bth->bst", e["x"][:, :64],
                             e["y"][:, :64]),
                    T.add_n([e["x"], e["y"], e["x"]]))),
    ]
    for n in ("sum", "prod", "max", "min", "amax", "amin", "nanmean",
              "nansum", "logsumexp", "std", "var"):
        for group, key in (("reductions", "x"), ("reductions_bf16", "xb")):
            cases.append((group, (n,), lambda e, n=n, k=key: getattr(T, n)(
                e[k][..., :16] if n == "prod" else e[k], axis=-1)))
    cases += [
        ("reductions", ("all", "any", "count_nonzero"),
         lambda e: (T.all(e["mask"], axis=-1), T.any(e["mask"], axis=-1),
                    T.count_nonzero(e["mask"], axis=-1))),
        ("reductions", ("cumprod", "cummax", "cummin"),
         lambda e: (T.cumprod(e["unit"][..., :64], dim=-1),
                    T.cummax(e["x"], axis=-1), T.cummin(e["x"], axis=-1))),
        ("reductions", ("nanmedian", "nanquantile", "numel"),
         lambda e: (T.nanmedian(e["special"], axis=-1),
                    T.nanquantile(e["special"], [0.1, 0.9], axis=-1),
                    T.numel(e["x"]))),
        ("logic", ("not_equal", "greater_than", "greater_equal",
                   "less_than", "less_equal", "logical_and", "logical_or",
                   "logical_xor", "logical_not", "is_empty", "is_tensor"),
         lambda e: (T.not_equal(e["ids"], e["ids"].flip(-1)),
                    T.greater_than(e["x"], e["y"]),
                    T.greater_equal(e["x"], e["y"]),
                    T.less_than(e["x"], 0.5), T.less_equal(e["i32"], 1.5),
                    T.logical_and(e["mask"], e["y"] > 0),
                    T.logical_or(e["mask"], e["y"] > 0),
                    T.logical_xor(e["mask"], e["y"] > 0),
                    T.logical_not(e["mask"]), T.is_empty(e["x"]),
                    T.full([1], T.is_tensor(e["x"]), device=e["dev"]))),
        ("search", ("argmin", "sort", "where", "index_select", "kthvalue"),
         lambda e: (T.argmin(e["x"], axis=-1),
                    T.sort(e["x"], axis=-1, descending=True),
                    T.where(e["mask"], e["x"], 0.0),
                    T.index_select(e["x"], e["gather"], axis=-1),
                    T.kthvalue(e["x"], 3, axis=-1))),
        ("search", ("mode", "bincount", "histogram", "histogramdd"),
         lambda e: (T.mode(e["ids"], axis=-1),
                    T.bincount(e["ids"].reshape(-1), minlength=50304),
                    T.histogram(e["x"], bins=100),
                    T.histogramdd(e["x"].reshape(-1, 1024)[:, :2],
                                  bins=[8, 8], ranges=[(-2, 2), (-2, 2)]))),
        ("host_read", ("nonzero", "masked_select"),
         lambda e: (T.nonzero(e["mask"][0, :4]),
                    T.masked_select(e["x"][0, :4], e["mask"][0, :4]))),
        ("creation", ("to_tensor", "as_tensor", "zeros", "ones", "full",
                      "empty", "zeros_like", "ones_like", "full_like",
                      "empty_like"),
         lambda e: (T.to_tensor(e["host"], device=e["dev"]),
                    T.as_tensor(e["host"].tolist(), device=e["dev"]),
                    T.zeros(list(e["x"].shape), device=e["dev"]),
                    T.ones([64, 3], "int32", device=e["dev"]),
                    T.full([64, 64], 1.5, device=e["dev"]),
                    T.empty([64], device=e["dev"]), T.zeros_like(e["x"]),
                    T.ones_like(e["x"], "int64"), T.full_like(e["x"], 2),
                    T.empty_like(e["x"]))),
        ("creation", ("arange", "linspace", "logspace", "eye", "meshgrid",
                      "diag", "diagflat", "tril", "triu"),
         lambda e: (T.arange(0, 1024, device=e["dev"]),
                    T.arange(0.0, 1.0, 1 / 1024, device=e["dev"]),
                    T.linspace(-2.5, 3.1, 1024, device=e["dev"]),
                    T.logspace(0, 2, 64, device=e["dev"]),
                    T.eye(64, device=e["dev"]),
                    T.meshgrid(e["row"][:64], e["row"][:32]),
                    T.diag(e["row"][:64], padding_value=-1.0, offset=1),
                    T.diag(e["mat"]), T.diagflat(e["row"][:64]),
                    T.tril(e["mat"]), T.triu(e["mat"], 1))),
        ("creation", ("assign", "clone", "tolist", "create_parameter",
                      "create_tensor", "complex"),
         lambda e: (T.assign(e["x"]), T.clone(e["x"]),
                    T.to_tensor(T.tolist(e["row"][:16]), device="cpu"),
                    T.create_parameter(
                        [64, 64], "float32",
                        default_initializer=Constant(0.5),
                        device=e["dev"]).detach(),
                    T.create_tensor("int32", device=e["dev"]),
                    T.complex(e["row"], e["row"].flip(0)))),
    ]
    return cases


LINSPACE_SPANS = ((0, 1, 7), (-2.5, 3.1, 13), (-1.7, 4.3, 33))


def breadth_faults(T):
    """The naive PyTorch calls on the card beside the port's on the CPU,
    as {name: (naive, port's)}.  linspace is held bitwise (jnp's formula
    is exact in the port; torch.linspace's is an ulp away)."""
    import torch
    big = torch.tensor([1e20, 3.0])
    return {
        "torch.linspace": (
            [torch.linspace(*a, device="cuda") for a in LINSPACE_SPANS],
            [T.linspace(*a, device="cpu") for a in LINSPACE_SPANS]),
        "torch.hypot(1e20)": (torch.hypot(big.cuda(), big.cuda()),
                              T.hypot(big, big)),
        "torch.digamma(0)": (torch.digamma(torch.zeros(3, device="cuda")),
                             T.digamma(torch.zeros(3))),
        "int32 + 1.5 in float32": (
            torch.arange(4, dtype=torch.int32, device="cuda") + 1.5,
            T.add(torch.arange(4, dtype=torch.int32), 1.5))}


def tensor_probe_phase(T, Constant, hidden, wte, ids, power):
    """tensor-probe (38).  Returns the phase's row."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    H = hidden.shape[-1]
    X = hidden[:, :-1].reshape(-1, H).float()
    Y = wte[ids[:, 1:].reshape(-1)]
    ms = {}
    with torch.inference_mode():
        G, A, Bm, lam = ridge_system(T, X, Y, PROBE_LAMBDA)
        W = ridge_solutions(T, X, Y, A, Bm, lam)
        ms["ridge_solves"] = wall_ms(
            lambda: ridge_solutions(T, X, Y, A, Bm, lam), reps=1)
        U, Sv, Vh = T.svd(X)
        w, V = T.eigh(A)
        Q, R = T.qr(X)
        lu, piv = T.lu(A)
        sld = T.slogdet(A)
        cond = float(T.cond(A))
        rank = int(T.matrix_rank(X))
        C, Cc = T.cov(X, rowvar=False), T.corrcoef(X, rowvar=False)
        a64 = A[:64, :64]
        a64n = T.divide(a64, T.norm(a64, p=2, axis=[0, 1]))
        inv = {
            "svd": (rel((U * Sv) @ Vh, X), max(ortho_err(U),
                                               ortho_err(Vh.T))),
            "eigh": (rel(A @ V, V * w), ortho_err(V)),
            "qr": (rel(Q @ R, X), ortho_err(Q)),
        }
        checks = {
            "svd_vs_eigvalsh": rel(Sv.flip(0) ** 2 / X.shape[0],
                                   T.eigvalsh(G)),
            "eigvalsh_vs_eigh": rel(T.eigvalsh(A), w),
            "qr_r": rel(T.qr(X, mode="r"), R),
            "lu": lu_err(lu, piv, A),
            "slogdet": abs(float(sld[1]) - float(torch.log(w).sum()))
            / abs(float(sld[1])),
            "cond": abs(cond - float(w[-1] / w[0])) * float(w[0] / w[-1]),
            "cov": rel(C, (X - X.mean(0)).T @ (X - X.mean(0))
                       / (X.shape[0] - 1)),
            "corrcoef_diag": float((torch.diagonal(Cc) - 1).abs().max()),
            "norm_fro": rel(T.norm(X), Sv.pow(2).sum().sqrt()),
            "norm_nuc": rel(T.norm(X, p="nuc", axis=[0, 1]), Sv.sum()),
            "norm_2": rel(T.norm(X, p=2, axis=[0, 1]), Sv[0]),
            "norm_1": rel(T.norm(X, p=1, axis=[0, 1]),
                          X.abs().sum(0).max()),
            "norm_inf_rows": rel(T.norm(X, p=float("inf"), axis=1),
                                 X.abs().amax(1)),
            "multi_dot": rel(T.multi_dot([X.T, X, W["solve"]]),
                             (X.T @ X) @ W["solve"]),
            "det": rel(T.det(a64), torch.exp(T.slogdet(a64)[1])
                       * T.slogdet(a64)[0]),
            "matrix_power": rel(T.matrix_power(a64n, 3),
                                a64n @ a64n @ a64n),
        }
        resid = {k: float(torch.linalg.norm(A @ v - Bm)
                          / (torch.linalg.norm(A) * torch.linalg.norm(v)))
                 for k, v in W.items()}
        agree = {k: rel(v, W["solve"]) for k, v in W.items()
                 if k != "solve"}
        rank_want = int((Sv > Sv.max() * max(X.shape)
                         * torch.finfo(Sv.dtype).eps).sum())
        naive_lu = lu_err(lu, torch.linalg.lu_factor(A).pivots.int(), A)
        # the probe again on 64 rows, card against CPU
        x64, y64 = X[:CPU_ROWS], Y[:CPU_ROWS]
        sys_card = ridge_system(T, x64, y64, PROBE_LAMBDA_64)
        w_card = ridge_solutions(T, x64, y64, *sys_card[1:])
        sys_cpu = ridge_system(T, x64.cpu(), y64.cpu(), PROBE_LAMBDA_64)
        w_cpu = ridge_solutions(T, x64.cpu(), y64.cpu(), *sys_cpu[1:])
        cpu64 = {k: rel(w_card[k].cpu(), w_cpu[k]) for k in w_card}
    log(f"tensor-probe: ridge from {X.shape[0]} x {H} hidden states to the "
        f"next token's embedding, lambda {float(lam):.4g}, cond(A) "
        f"{cond:.4g}, rank(X) {rank}; residual ||AW - B|| / (||A|| ||W||) "
        f"{resid}; agreement with solve {agree} (tol {TOL_AGREE:g})")
    log(f"tensor-probe: invariants (reconstruction, orthogonality) {inv}; "
        f"relative checks {checks}; 64 rows card vs CPU {cpu64}; the naive "
        f"lu_factor pivots reconstruct to {naive_lu:.3g}")
    stable = ("cholesky", "triangular", "solve", "lstsq")
    if any(resid[k] > TOL_RESID for k in stable) or \
            any(v > TOL_AGREE for v in agree.values()):
        fail("the probe's solutions disagree or leave a residual")
    if any(r > TOL_RESID or o > TOL_ORTHO for r, o in inv.values()):
        fail("a decomposition does not reconstruct or is not orthogonal")
    loose = {"cond": TOL_AGREE, "svd_vs_eigvalsh": TOL_AGREE}
    bad = [k for k, v in checks.items() if not v <= loose.get(k, TOL_RESID)]
    if bad or rank != rank_want or int(sld[0]) != 1:
        fail(f"probe checks failed: {bad}, rank {rank} vs {rank_want}")
    if any(v > TOL_AGREE for v in cpu64.values()):
        fail("the 64-row probe on the card disagrees with the CPU")
    if not naive_lu > TOL_RESID:
        fail("torch.linalg.lu_factor's 1-based pivots pass the lu check")
    # breadth: every other name once, card against a CPU copy of 64 rows
    cases = tensor_breadth_cases(T, Constant)
    covered = {n for _, names, _ in cases for n in names}
    probe_names = {"matmul", "divide", "add", "multiply", "eye", "trace",
                   "sqrt", "cholesky", "cholesky_solve", "triangular_solve",
                   "solve", "inverse",
                   "lstsq", "pinv", "svd", "eigh", "eigvalsh", "qr", "lu",
                   "slogdet", "cond", "matrix_rank", "cov", "corrcoef",
                   "norm", "multi_dot", "det", "matrix_power", "zeros",
                   "logsumexp", "index_sample", "mean", "subtract", "exp",
                   "accuracy", "argmax", "equal", "topk", "argsort",
                   "cumsum", "searchsorted", "quantile", "median",
                   "full_like", "eig", "eigvals", "mode"}
    full = breadth_env(T, hidden.float(), ids)
    small = breadth_env(T, hidden[:1, :CPU_ROWS].float(), ids[:, :CPU_ROWS])
    small_cpu = breadth_env(T, hidden[:1, :CPU_ROWS].float().cpu(),
                            ids[:, :CPU_ROWS].cpu())
    worst, bad = {}, []
    with torch.inference_mode():
        for group, names, fn in cases:
            tol = TOL_BF16 if group.endswith("bf16") else TOL_F32
            same, err = outputs_err(fn(small), fn(small_cpu))
            worst[group] = max(worst.get(group, 0.0), err)
            if not same or err > tol:
                bad.append((names, same, err))
        # eig / eigvals: complex, in no defined order; held by A V = V w
        # and the same set from both calls
        ew, ev = T.eig(small["mat"])
        ewc = T.eigvals(small["mat"])
        eig_res = float(torch.linalg.norm(small["mat"].to(ev.dtype) @ ev
                                          - ev * ew)
                        / torch.linalg.norm(small["mat"]))
        key = (lambda z: torch.sort(z.real * 1e6 + z.imag).values)
        eig_set = float((key(ew) - key(ewc)).abs().max())
        try:
            T.linalg.mode(small["x"])
        except NotImplementedError:
            mode_raises = True
        else:
            mode_raises = False
        for group in sorted({g for g, _, _ in cases}):
            calls = [fn for g, _, fn in cases if g == group]
            ms[f"breadth_{group}"] = wall_ms(
                lambda calls=calls: [f(full) for f in calls], reps=1)
        faults = {k: outputs_err(*p) for k, p in breadth_faults(T).items()}
        linspace_card = outputs_err(
            [T.linspace(*a, device="cuda") for a in LINSPACE_SPANS],
            [T.linspace(*a, device="cpu") for a in LINSPACE_SPANS])
    caught = {k: not (s and e <= (0.0 if k == "torch.linspace" else TOL_F32))
              for k, (s, e) in faults.items()}
    first_half = (T.creation, T.math, T.linalg, T.logic, T.stat, T.search)
    names_all = {n for m in first_half for n in m.__all__}
    missing = sorted(names_all - covered - probe_names)
    log(f"tensor-probe breadth: {len(cases)} cases over {len(covered)} "
        f"names, card vs CPU ({CPU_ROWS} rows) max scaled err by group "
        f"{worst}; eig A V = V w {eig_res:.3g}, eigvals vs eig {eig_set:.3g}"
        f"; linalg.mode raises {mode_raises}; planted faults told apart "
        f"{caught}; linspace card vs CPU {linspace_card}"
        + (f"; differ: {bad}" if bad else ""))
    if bad or linspace_card != (True, 0.0):
        fail(f"breadth card vs CPU differ: {bad}, linspace {linspace_card}")
    if missing:
        fail(f"names of the tensor library no phase runs: {missing}")
    if eig_res > TOL_RESID * 10 or eig_set > TOL_RESID or not mode_raises:
        fail("eig / eigvals / linalg.mode do not hold")
    if not all(caught.values()):
        fail(f"a naive call passes the breadth check: {caught}")
    peak = torch.cuda.max_memory_allocated()
    log(f"tensor-probe: ms a call group at the full shape {ms}; peak "
        f"{peak} bytes [{power}]")
    return {"ms": ms, "peak_bytes": peak,
            "lambda": float(lam), "cond": cond, "rank": rank,
            "residual": resid, "agreement": agree, "invariants": inv,
            "checks": checks, "cpu64": cpu64, "breadth_err": worst,
            "planted_faults_caught": {**caught, "torch lu_factor pivots":
                                      naive_lu > TOL_RESID}}


# -- phases 39-41: the tensor library's second half and the namespace --------

def _bits(t):
    """t's bits as an integer tensor of the same width (bool and integer
    tensors as they are)."""
    import torch
    width = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    if t.is_floating_point():
        return t.contiguous().view(width[t.element_size()])
    return t


def state_mismatches(saved, loaded, prefix=""):
    """The keys (dotted) whose loaded value is not the saved one: missing,
    extra, another type, dtype or shape, or other bits."""
    import torch
    if isinstance(saved, dict):
        if not isinstance(loaded, dict):
            return [prefix.rstrip(".") or "."]
        bad = [f"{prefix}{k}" for k in set(saved) ^ set(loaded)]
        for k in set(saved) & set(loaded):
            bad += state_mismatches(saved[k], loaded[k], f"{prefix}{k}.")
        return bad
    if isinstance(saved, torch.Tensor):
        same = (isinstance(loaded, torch.Tensor)
                and loaded.dtype == saved.dtype
                and loaded.shape == saved.shape
                and torch.equal(_bits(saved), _bits(loaded.to(
                    saved.device))))
        return [] if same else [prefix.rstrip(".")]
    same = type(saved) is type(loaded) and saved == loaded
    return [] if same else [prefix.rstrip(".")]


def _optimizer_tensors(opt, model):
    """(name, tensor) of every parameter and every tensor of its
    optimizer state."""
    out = []
    for i, p in enumerate(model.parameters()):
        out.append((f"param_{i}", p.detach()))
        for k, v in opt._state_for(p).items():
            if hasattr(v, "dtype"):
                out.append((f"param_{i}.{k}", v.detach()))
    return out


def _pair_diff(a, b):
    """(entries that differ, the largest |a - b| over max |b|) of two
    lists of (name, tensor)."""
    n, worst = 0, 0.0
    for (_, x), (_, y) in zip(a, b):
        d = (x.float() - y.float()).abs()
        n += int((_bits(x) != _bits(y)).sum())
        worst = max(worst, float(d.max()) / max(float(y.float().abs().max()),
                                                1e-30))
    return n, worst


def gpt_checkpoint_phase(base, gpt_loss, amp, AdamW, CosineAnnealingDecay, fa,
                         fused_adam, ids_t, io, power):
    """gpt-checkpoint (39): two pairs of (copy of ``base``, GPT-2 345M,
    decorated O2; its fused AdamW), one resumed from the other's files.
    Returns (the phase's row, launch counts)."""
    import copy
    import os
    import tempfile
    import torch
    torch.cuda.reset_peak_memory_stats()

    def make():
        model = copy.deepcopy(base)
        sched = CosineAnnealingDecay(EAGER_LR, T_max=CKPT_T_MAX)
        opt = AdamW(sched, beta2=0.99, parameters=list(model.parameters()),
                    use_fused=True)
        model, opt = amp.decorate(model, opt, level="O2")
        return model, opt, sched, amp.GradScaler()

    def step(pair):
        model, opt, sched, scaler = pair
        with amp.auto_cast(level="O2"):
            loss = gpt_loss(model, ids_t, ids_t)
        scaler.minimize(opt, scaler.scale(loss))
        opt.clear_grad()
        sched.step()
        return float(loss.detach())

    reset_fa(fa)
    fused_adam.launches_bf16 = 0
    orig = make()
    losses = [step(orig) for _ in range(2)]
    saved_m = {k: v.clone() for k, v in orig[0].state_dict().items()}
    saved_o = orig[1].state_dict()
    saved_s = orig[3].state_dict()
    if any(v.dtype != torch.bfloat16 for v in saved_m.values()):
        fail("gpt-checkpoint: a decorated parameter is not bf16")
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, "gpt.pdparams"),
                 os.path.join(tmp, "gpt.pdopt")]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for obj, path in zip((saved_m, saved_o), paths):
            io.save(obj, path)
        t_save = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(p) for p in paths)
        t0 = time.perf_counter()
        loaded_m, loaded_o = (io.load(p) for p in paths)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    blobs = [io.dumps(saved_m), io.dumps(saved_o)]
    t_dumps = time.perf_counter() - t0
    t0 = time.perf_counter()
    mem_m, mem_o = (io.loads(b) for b in blobs)
    torch.cuda.synchronize()
    t_loads = time.perf_counter() - t0
    del blobs
    bad = {"file": state_mismatches(saved_m, loaded_m)
           + state_mismatches(saved_o, loaded_o),
           "memory": state_mismatches(saved_m, mem_m)
           + state_mismatches(saved_o, mem_o)}
    dropped = sorted(k for k in loaded_o if k.endswith("_moment2"))[0]
    planted = {k: v for k, v in loaded_o.items() if k != dropped}
    caught = {"state dict missing one moment": bool(
        state_mismatches(saved_o, planted))}
    del mem_m, mem_o, planted
    resumed = make()
    resumed[0].set_state_dict(loaded_m)
    resumed[1].set_state_dict(loaded_o)
    resumed[3].set_state_dict(io.loads(io.dumps(saved_s)))
    bad["set_state_dict"] = state_mismatches(saved_o,
                                             resumed[1].state_dict())
    del loaded_m, loaded_o
    # step 3 on both pairs, then the original again from its step-2 state
    # (in memory, no file): the spread a repeat of the step has
    loss_o = step(orig)
    after_o = [(n, t.clone()) for n, t in _optimizer_tensors(orig[1],
                                                             orig[0])]
    loss_r = step(resumed)
    after_r = _optimizer_tensors(resumed[1], resumed[0])
    orig[0].set_state_dict(saved_m)
    orig[1].set_state_dict(saved_o)
    orig[3].set_state_dict(saved_s)
    loss_rep = step(orig)
    after_rep = _optimizer_tensors(orig[1], orig[0])
    diff_r = _pair_diff(after_r, after_o)
    diff_rep = _pair_diff(after_rep, after_o)
    launches = {"flash_attention_fwd": fa.launches,
                "flash_attention_bwd_dq": fa.launches_dq,
                "flash_attention_bwd_dkv": fa.launches_dkv,
                "fused_adam_bf16": fused_adam.launches_bf16}
    peak = torch.cuda.max_memory_allocated()
    log(f"gpt-checkpoint: GPT-2 345M decorate(O2), AdamW(CosineAnnealing"
        f"Decay({EAGER_LR:g}), beta2=0.99, use_fused=True), GradScaler, "
        f"B={ids_t.shape[0]}, S={ids_t.shape[1]}: losses {losses}; "
        f"{len(saved_m)} parameters, {len(saved_o)} optimizer entries, "
        f"{nbytes} file bytes: save {t_save:.3f} s "
        f"({nbytes / t_save / 1e9:.3f} GB/s), load {t_load:.3f} s "
        f"({nbytes / t_load / 1e9:.3f} GB/s); dumps {t_dumps:.3f} s, "
        f"loads {t_loads:.3f} s; mismatches {bad}; planted faults told "
        f"apart {caught}")
    log(f"gpt-checkpoint: step 3 losses original {loss_o!r}, resumed "
        f"{loss_r!r}, the original repeated {loss_rep!r}; entries that "
        f"differ and the largest difference over scale: resumed "
        f"{diff_r}, repeat {diff_rep}; launches {launches}; peak {peak} "
        f"bytes [{power}]")
    if any(bad.values()):
        fail(f"gpt-checkpoint: a loaded tensor is not the saved one: {bad}")
    if not all(caught.values()):
        fail(f"gpt-checkpoint: a planted fault passes the check: {caught}")
    if diff_rep[0] == 0 and loss_rep == loss_o:
        if diff_r[0] or loss_r != loss_o:
            fail("gpt-checkpoint: the resumed step is not bitwise the "
                 "original's")
    elif diff_r[1] > 4 * diff_rep[1] or \
            abs(loss_r - loss_o) > 4 * abs(loss_rep - loss_o):
        fail("gpt-checkpoint: the resumed step is outside the repeat's "
             "spread")
    if not all(math.isfinite(x) for x in losses + [loss_o]):
        fail("gpt-checkpoint: a loss is not finite")
    row = {"file_bytes": nbytes, "save_s": t_save, "load_s": t_load,
           "dumps_s": t_dumps, "loads_s": t_loads,
           "save_gb_per_s": nbytes / t_save / 1e9,
           "load_gb_per_s": nbytes / t_load / 1e9, "losses": losses,
           "step3_losses": [loss_o, loss_r, loss_rep],
           "resumed_diff": list(diff_r), "repeat_diff": list(diff_rep),
           "planted_faults_caught": caught, "peak_bytes": peak}
    del orig, resumed, saved_m, saved_o, after_o
    torch.cuda.empty_cache()
    return row, launches


def nucleus_step(T, F, last):
    """One sampled token a row of the f32 logits ``last`` (B, V): topk,
    the nucleus at SAMPLE_P (softmax, cumsum, a mask), multinomial."""
    vals, idx = T.topk(last, SAMPLE_TOPK)
    probs = F.softmax(vals, axis=-1)
    before = T.subtract(T.cumsum(probs, axis=-1), probs)
    probs = T.where(T.less_than(before, T.full_like(probs, SAMPLE_P)), probs,
                    T.zeros_like(probs))
    return T.take_along_axis(idx, T.multinomial(probs, 1), axis=1)


def topk_only_step(T, F, last):
    """The planted fault: the nucleus ignored."""
    vals, idx = T.topk(last, SAMPLE_TOPK)
    return T.take_along_axis(idx, T.multinomial(F.softmax(vals, axis=-1),
                                                1), axis=1)


def outside_nucleus(lasts, toks):
    """How many sampled tokens have a logit below their step's smallest
    kept logit, the kept set recomputed by torch.sort and torch.softmax
    (tie-proof: by value, not index)."""
    import torch
    n = 0
    for last, tok in zip(lasts, toks):
        v = torch.sort(last, dim=-1, descending=True).values[:, :SAMPLE_TOPK]
        p = torch.softmax(v, dim=-1)
        kept = (torch.cumsum(p, dim=-1) - p) < SAMPLE_P
        floor = torch.where(kept, v, torch.full_like(v, float("inf"))).amin(-1)
        n += int((last.gather(1, tok)[:, 0] < floor).sum())
    return n


def gpt_sample_phase(tpt, F, base, fa, power):
    """gpt-sample (40) on a copy of ``base``, phase 3's GPT-2 345M in
    bf16.  Returns (the phase's row, launch counts)."""
    import copy
    import numpy as np
    import torch
    T = tpt.tensor
    torch.cuda.reset_peak_memory_stats()
    model = copy.deepcopy(base)
    v = model.config.vocab_size
    prompt = torch.as_tensor(np.random.default_rng(40).integers(
        0, v, (B, SAMPLE_PROMPT)), device=model.wte.device)

    @tpt.no_grad()
    def generate(seed):
        tpt.seed(seed)
        seq, lasts, toks = prompt, [], []
        for _ in range(SAMPLE_NEW):
            last = model(seq)[:, -1].float()
            tok = nucleus_step(T, F, last)
            lasts.append(last)
            toks.append(tok)
            seq = T.concat([seq, tok], axis=1)
        return seq[:, SAMPLE_PROMPT:], lasts, toks

    reset_fa(fa)
    first, lasts, toks = generate(SAMPLE_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, _, _ = generate(SAMPLE_SEED)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    other, _, _ = generate(SAMPLE_SEED + 1)
    launches = {"flash_attention_fwd": fa.launches}
    with torch.no_grad():
        state = tpt.get_rng_state()
        a = nucleus_step(T, F, lasts[5])
        tpt.set_rng_state(state)
        replay = bool(torch.equal(a, nucleus_step(T, F, lasts[5])))
        outside = outside_nucleus(lasts, toks)
        tpt.seed(SAMPLE_SEED)
        naive = [topk_only_step(T, F, last) for last in lasts]
        naive_outside = outside_nucleus(lasts, naive)
    caught = {"sampler ignoring the nucleus": naive_outside > 0}
    peak = torch.cuda.max_memory_allocated()
    step_ms = gen_s / SAMPLE_NEW * 1e3
    log(f"gpt-sample: GPT-2 345M (bf16), {B} x {SAMPLE_PROMPT} prompt, "
        f"{SAMPLE_NEW} tokens a row by full re-forward, topk({SAMPLE_TOPK}) "
        f"then the nucleus at {SAMPLE_P}: first row {first[0, :8].tolist()}"
        f"...; same seed bitwise {bool(torch.equal(first, again))}, another "
        f"seed differs {not bool(torch.equal(first, other))}, "
        f"set_rng_state replays {replay}; tokens outside the kept set "
        f"{outside} (the nucleus ignored: {naive_outside}); {step_ms:.3f} ms "
        f"a step of {B} tokens, {B * SAMPLE_NEW / gen_s:.1f} generated "
        f"tokens/s; launches {launches}; peak {peak} bytes [{power}]")
    if not torch.equal(first, again) or torch.equal(first, other):
        fail("gpt-sample: a seed does not fix the tokens")
    if not replay or outside:
        fail("gpt-sample: a replay differs, or a token lies outside the "
             "nucleus")
    if not all(caught.values()):
        fail(f"gpt-sample: a planted fault passes the check: {caught}")
    if launches["flash_attention_fwd"] != 3 * SAMPLE_NEW * \
            model.config.num_layers:
        fail(f"gpt-sample: {launches} flash forward launches")
    row = {"ms_a_step": step_ms, "generated_tokens_per_s":
           B * SAMPLE_NEW / gen_s, "peak_bytes": peak,
           "planted_faults_caught": caught,
           "naive_tokens_outside": naive_outside}
    del model
    torch.cuda.empty_cache()
    return row, launches


def bert_hidden(model, ids, mask):
    """BERT's last-layer hidden states (B, S, H)."""
    import torch
    from paddle_tpu_torch.models.bert import _PARAM_ORDER, _bert_forward
    return _bert_forward(model.config, {n: getattr(model, n)
                                        for n in _PARAM_ORDER},
                         ids, torch.zeros_like(ids), mask,
                         features_only=True)


SEQ_POOLS = ("average", "sum", "sqrt", "max", "min", "first", "last")


def ragged_ops(T, F, hf, lens, ids_pad, table, w_att):
    """The sequence calls of phase 41 on the padded hidden states hf (B,
    S, H) f32 with lengths lens, ids_pad (B, S) and a word table."""
    b, s = ids_pad.shape
    seg = T.lengths_to_segment_ids(lens)
    flat = F.sequence_unpad(hf, lens)
    out = {f"pool_{t}": F.sequence_pool(hf, t, lens) for t in SEQ_POOLS}
    out["pool_max_pad"] = F.sequence_pool(hf, "max", lens, pad_value=-1.0)
    out["first_step"] = F.sequence_first_step(hf, lens)
    out["last_step"] = F.sequence_last_step(hf, lens)
    att = F.segment_softmax(T.matmul(flat, w_att), seg, num_segments=b)
    out["attention_pool"] = T.segment_sum(T.multiply(att[:, None], flat),
                                          seg, num_segments=b)
    out["segment_mean"] = T.segment_mean(flat, seg, num_segments=b + 1)
    out["segment_max"] = T.segment_max(flat, seg, num_segments=b + 1)
    out["segment_min"] = T.segment_min(flat, seg)
    out["segment_ids_to_lengths"] = T.segment_ids_to_lengths(seg, b)
    for mode in ("sum", "mean", "max"):
        out[f"bag_{mode}"] = F.embedding_bag(ids_pad, table, lens, mode=mode,
                                             padding_idx=0)
    out["bag_flat_max"] = F.embedding_bag(
        F.sequence_unpad(ids_pad[..., None], lens)[:, 0], table, seg,
        mode="max")
    out["softmax"] = F.sequence_softmax(hf[..., 0], lens)
    out["reverse"] = F.sequence_reverse(hf, lens)
    half = s // 2
    out["concat"] = F.sequence_concat(
        [hf[:, :half], hf[:, half:]],
        [lens.clamp(max=half), (lens - half).clamp(min=0)])
    out["enumerate"] = F.sequence_enumerate(ids_pad, 3, pad_value=-1,
                                            lengths=lens)
    out["expand_as"] = F.sequence_expand_as(out["pool_average"], lens)
    out["mask"] = F.sequence_mask(lens, maxlen=s, dtype="float32")
    return out


def manip_env(x, ids):
    """The manipulation breadth's inputs from an activation x (B, S, H)
    and ids (B, S): every index holds a negative entry and one past its
    axis, the overwriting ones duplicates."""
    import torch
    dev, (b, s, h) = x.device, x.shape
    g = torch.Generator().manual_seed(41)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g).to(dev)
    nd = torch.tensor([[0, 0], [-1, -1], [9, 3], [0, 2000], [-20, 1],
                       [0, 5]]).to(dev)
    return {"x": x, "xb": x.to(torch.bfloat16), "ids": ids,
            "gidx": torch.tensor([0, 5, -1, 2000, 3]).to(dev),
            "nd": nd, "nd_upd": torch.randn(6, h, generator=g).to(dev),
            "tidx": ints(-h - 2, h + 2, (b, s, 4)),
            "tval": torch.randn(b, s, 4, generator=g).to(dev),
            "sidx": ints(-h - 2, h + 2, (s, 4)),
            "rows": torch.tensor([0, 3, 3, -1, 10 ** 6, 7, 0]).to(dev),
            "rows_upd": torch.randn(7, h, generator=g).to(dev),
            "ia_val": torch.randn(b, 5, h, generator=g).to(dev),
            "reps": torch.tensor([2, 0, 1, 3]).to(dev),
            "special": torch.tensor([float("nan"), 1e20, -1e20, 3.7, -3.7,
                                     2.5e9]).to(dev)}


def manip_cases(T):
    """(group, names, fn(env, dtype key)) for every name of
    tensor/manipulation.py."""
    return [
        ("layout", ("reshape", "reshape_", "flatten", "transpose",
                    "moveaxis", "swapaxes", "t"),
         lambda e, d: (T.reshape(e[d], [-1, e[d].shape[-1]]),
                       T.reshape_(e[d].clone(), [-1]),
                       T.flatten(e[d], 1), T.transpose(e[d], [2, 0, 1]),
                       T.moveaxis(e[d], 0, 2), T.swapaxes(e[d], 1, 2),
                       T.t(e[d][0]))),
        ("join", ("concat", "stack", "unstack", "split", "chunk", "unbind"),
         lambda e, d: (T.concat([e[d], e["x"]], axis=1),
                       T.stack([e[d], e[d]], axis=0),
                       T.unstack(e[d], axis=0),
                       T.split(e[d], [256, -1, 256], axis=2),
                       T.chunk(e[d], 4, axis=2), T.unbind(e[d], 0))),
        ("shape", ("squeeze", "squeeze_", "unsqueeze", "unsqueeze_", "tile",
                   "expand", "expand_as", "broadcast_to",
                   "broadcast_tensors"),
         lambda e, d: (T.squeeze(T.unsqueeze(e[d], [0, -1]), [0, -1]),
                       T.squeeze_(e[d][:, :1]), T.unsqueeze_(e[d], 1),
                       T.tile(e[d][:, :4], [1, 2, 1]),
                       T.expand(e[d][:, :1], [-1, 4, -1]),
                       T.expand_as(e[d][:, :1], e[d]),
                       T.broadcast_to(e[d][:1], list(e[d].shape)),
                       T.broadcast_tensors([e[d][:, :1], e[d]]))),
        ("order", ("flip", "rot90", "roll"),
         lambda e, d: (T.flip(e[d], [0, 2]), T.rot90(e[d], 1, [1, 2]),
                       T.roll(e[d], [3, -5], [1, 2]))),
        ("gather", ("gather", "gather_nd", "take_along_axis", "index_select",
                    "index_sample"),
         lambda e, d: (T.gather(e[d], e["gidx"], axis=1),
                       T.gather_nd(e[d], e["nd"]),
                       T.take_along_axis(e[d], e["tidx"], axis=2),
                       T.manipulation.index_select(e[d], e["gidx"], axis=2),
                       T.manipulation.index_sample(e[d][0], e["sidx"]))),
        ("scatter", ("put_along_axis", "scatter", "scatter_nd_add",
                     "scatter_nd", "index_add"),
         lambda e, d: (T.put_along_axis(e[d], e["tidx"], 1.5, 2),
                       T.put_along_axis(e[d], e["tidx"], e["tval"], 2,
                                        reduce="add"),
                       T.scatter(e[d].reshape(-1, e[d].shape[-1]), e["rows"],
                                 e["rows_upd"]),
                       T.scatter(e[d].reshape(-1, e[d].shape[-1]), e["rows"],
                                 e["rows_upd"], overwrite=False),
                       T.scatter_nd_add(e[d], e["nd"], e["nd_upd"]),
                       T.scatter_nd(e["nd"], e["nd_upd"].to(e[d].dtype),
                                    list(e[d].shape)),
                       T.index_add(e[d], e["gidx"], 1, e["ia_val"]))),
        ("slice", ("slice", "strided_slice", "crop", "pad"),
         lambda e, d: (T.slice(e[d], [1, 2], [-100, 3], [2000, -1]),
                       T.strided_slice(e[d], [1, 2], [-1, 0], [0, 1024],
                                       [-3, 5]),
                       T.crop(e[d], [1, 32, -1], [0, 8, 100]),
                       T.pad(e[d], [2, 3], mode="reflect"))),
        ("dtype", ("cast", "as_complex", "as_real", "real", "imag",
                   "tensordot"),
         lambda e, d: (T.cast(e["special"], "int32"), T.cast(e[d], "bool"),
                       T.cast(e[d], "float32"), T.real(T.as_complex(
                           e["x"][..., :64].reshape(-1, 32, 2))),
                       T.as_real(T.as_complex(e["x"][..., :8].reshape(
                           -1, 4, 2))),
                       T.imag(T.as_complex(e["x"][..., :8].reshape(
                           -1, 4, 2))),
                       T.tensordot(e[d][0], e[d][0], axes=([1], [1])))),
        ("host", ("unique", "unique_consecutive", "repeat_interleave"),
         lambda e, d: (T.unique(e["ids"] % 4096, return_index=True,
                                return_inverse=True, return_counts=True),
                       T.unique_consecutive(e["ids"] // 8192,
                                            return_inverse=True,
                                            return_counts=True, axis=1),
                       T.repeat_interleave(e[d][:, :4], e["reps"], axis=1),
                       T.repeat_interleave(e[d][:, :2], 2))),
        ("indices", ("tril_indices", "triu_indices", "one_hot",
                     "shard_index"),
         lambda e, d: (T.tril_indices(64, 48, -1, device=e["x"].device),
                       T.triu_indices(64, None, 2, device=e["x"].device),
                       T.one_hot(e["ids"] % 64, 64),
                       T.shard_index(e["ids"], 50304, 4, 1, ignore_value=-7))),
    ]


def sampler_stats(T, n):
    """Each sampler's n draws on the card: (name, ok, mean, var, dtype)
    against its distribution (mean and variance within 6 sigma)."""
    import torch
    dev = "cuda"
    draws = {
        "rand": (lambda: T.rand([n], device=dev), 0.5, 1 / 12),
        "randn": (lambda: T.randn([n], device=dev), 0.0, 1.0),
        "standard_normal": (lambda: T.standard_normal([n], device=dev), 0.0,
                            1.0),
        "randint": (lambda: T.randint(-3, 5, [n], device=dev), 0.5,
                    63 / 12),
        "randint_like": (lambda: T.randint_like(torch.zeros(
            n, dtype=torch.int32, device=dev), 0, 7), 3.0, 48 / 12),
        "uniform": (lambda: T.uniform([n], min=-2.0, max=3.0, device=dev),
                    0.5, 25 / 12),
        "normal": (lambda: T.normal(1.5, 2.0, [n], device=dev), 1.5, 4.0),
        "poisson": (lambda: T.poisson(torch.full((n,), 3.0, device=dev)),
                    3.0, 3.0),
        "bernoulli": (lambda: T.bernoulli(torch.full((n,), 0.3,
                                                     device=dev)),
                      0.3, 0.21),
        "uniform_": (lambda: T.uniform_(torch.empty(n, device=dev), 0.5,
                                        1.5), 1.0, 1 / 12),
        "normal_": (lambda: T.normal_(torch.empty(n, device=dev), -1.0,
                                      0.5), -1.0, 0.25),
        "exponential_": (lambda: T.exponential_(torch.empty(
            n, device=dev), 2.0), 0.5, 0.25)}
    rows = []
    for name, (fn, mean, var) in draws.items():
        a = fn()
        x = a.double()
        m, vv = float(x.mean()), float(x.var())
        # the variance's sampling error for an excess kurtosis up to 6
        # (the exponential's)
        ok = (abs(m - mean) < 6 * math.sqrt(var / n)
              and abs(vv - var) < 6 * var * math.sqrt(8.0 / n))
        rows.append((name, ok, m, vv, str(a.dtype)))
    perm = T.randperm(n, device=dev)
    rows.append(("randperm", bool(torch.equal(
        torch.sort(perm).values, torch.arange(n, device=dev))), 0.0, 0.0,
        str(perm.dtype)))
    probs = torch.rand(n // 4, 8, device=dev)
    probs[:, 5:] = 0                       # fewer non-zeros than samples
    probs[0] = 0                           # and a row of zeros
    pick = T.multinomial(probs, 6)
    distinct = bool((torch.sort(pick, -1).values.diff(dim=-1) > 0).all())
    rows.append(("multinomial", distinct and bool((pick[1:, :5] < 5).all()),
                 0.0, 0.0, str(pick.dtype)))
    return rows


def double_backward(tpt, x):
    """The gradient of |grad f|^2 for f = sum(x^3 sin x), through
    grad(create_graph=True) twice."""
    x = x.detach().clone().requires_grad_()
    g = tpt.grad((x ** 3 * x.sin()).sum(), x, create_graph=True)[0]
    h = tpt.grad((g * g).sum(), x, create_graph=True)[0]
    return [g.detach(), h.detach(), tpt.grad(h.sum(), x)[0]]


def alias_calls(tpt, x, idx):
    """The top-level compat names once each on x (N, M) and row indices
    idx."""
    y = x.flip(0)
    t = x.clone()
    tpt.tanh_(t)
    s = x.clone()
    tpt.scatter_(s, idx, y[:idx.shape[0]])
    return [tpt.elementwise_add(x, y), tpt.elementwise_sub(x, y),
            tpt.elementwise_div(x, y), tpt.elementwise_floordiv(x, y),
            tpt.elementwise_mod(x, y), tpt.elementwise_pow(x.abs(), y),
            tpt.reduce_sum(x, 0), tpt.reduce_mean(x), tpt.reduce_max(x, 1),
            tpt.reduce_min(x), tpt.reduce_prod(x[:4, :4]),
            tpt.crop_tensor(x, [4, 4], [1, 2]), tpt.rank(x), tpt.shape(x),
            tpt.has_nan(x), tpt.has_inf(x), t, s,
            tpt.fill_constant([3], "int32", 7, force_cpu=x.device.type ==
                              "cpu").to(x.device)]


def bert_ragged_phase(tpt, Bert, bert_base, fa, power):
    """bert-ragged and breadth (41).  Returns (the phase's row, launch
    counts)."""
    import numpy as np
    import torch
    T = tpt.tensor
    F = tpt.nn.functional
    torch.cuda.reset_peak_memory_stats()
    dev, bsz, s_len = "cuda", BERT_B, BERT_S
    cfg = bert_base(max_seq_len=s_len)
    model = Bert(cfg, device=dev).to(torch.bfloat16)
    rng = np.random.default_rng(41)
    lens_np = rng.integers(RAGGED_MIN, s_len + 1, bsz)
    lens = torch.as_tensor(lens_np, device=dev)
    flat_ids = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                            int(lens_np.sum())), device=dev)
    w_att = torch.as_tensor(rng.standard_normal(cfg.hidden_size) / 28.0,
                            dtype=torch.float32, device=dev)
    table = model.wte.detach().float()
    reset_fa(fa)
    # 1-2: the flat batch padded to 128 x 128, BERT over it, masked
    seg = T.lengths_to_segment_ids(lens)
    ids_pad, _ = F.sequence_pad(flat_ids, 0, lens, maxlen=s_len)
    mask = F.sequence_mask(lens, maxlen=s_len)
    hidden = bert_hidden(model, ids_pad, mask)
    fwd_launches = fa.launches_masked
    # 3-5: unpad, pool, and one backward of a pooled loss
    hf = hidden.float()
    flat = F.sequence_unpad(hf, lens)
    att = F.segment_softmax(T.matmul(flat, w_att), seg)
    pooled = T.segment_sum(T.multiply(att[:, None], flat), seg)
    loss = T.add(T.mean(T.square(F.sequence_pool(hf, "max", lens))),
                 T.mean(T.square(pooled)))
    tpt.autograd.backward(loss)
    grads_finite = all(bool(torch.isfinite(p.grad).all())
                       for p in model.parameters() if p.grad is not None)
    launches = {"flash_attention_fwd_masked": fa.launches_masked,
                "flash_attention_bwd_dq_masked": fa.launches_dq_masked,
                "flash_attention_bwd_dkv_masked": fa.launches_dkv_masked}
    hf = hf.detach()
    with torch.no_grad():
        # 6: the sequence ops, card against a CPU copy of the same inputs
        ms = {"ragged_ops": wall_ms(lambda: ragged_ops(
            T, F, hf, lens, ids_pad, table, w_att), reps=1)}
        card = ragged_ops(T, F, hf, lens, ids_pad, table, w_att)
        cpu = ragged_ops(T, F, hf.cpu(), lens.cpu(), ids_pad.cpu(),
                         table.cpu(), w_att.cpu())
        errs = {k: outputs_err(card[k], cpu[k]) for k in card}
        flat = F.sequence_unpad(hf, lens)
        round_trip = bool(torch.equal(F.sequence_unpad(F.sequence_pad(
            flat, 0.0, lens, maxlen=s_len)[0], lens), flat))
        looked = F.sequence_pool(T.gather(table, ids_pad, axis=0) * (
            ids_pad != 0)[..., None], "sum", lens) / T.maximum(
            ((ids_pad != 0) & mask.bool()).sum(1, keepdim=True), 1)
        bag_err = scaled_err(card["bag_mean"], looked)
        # planted faults, told apart by the same card-vs-CPU measure
        ties = hf[:4, :16].clone()
        ties[:, 3] = ties[:, 7]
        tl = lens[:4].clamp(max=16)
    control, faults = sequence_faults(T, F, ties, tl, flat, seg)
    bad = [k for k, (same, e) in errs.items() if not same or e > TOL_F32]
    if not control[0] or control[1] > TOL_F32:
        bad.append(f"the tie gradient {control}")
    caught = {k: not (s and e <= TOL_F32) for k, (s, e) in faults.items()}
    try:
        torch.multinomial(torch.zeros(1, 8), 3)
        caught["torch.multinomial of a row of zeros"] = False
    except RuntimeError:
        caught["torch.multinomial of a row of zeros"] = bool(
            (T.multinomial(torch.zeros(1, 8, device=dev), 3) < 8).all())
    # breadth: every manipulation name once at GPT-2's activation
    gen = torch.Generator(device=dev).manual_seed(41)
    x = torch.randn(B, S, 1024, device=dev, generator=gen)
    ids = torch.randint(0, 50304, (B, S), device=dev, generator=gen)
    full = manip_env(x, ids)
    small = manip_env(x[:1, :CPU_ROWS].clone(), ids[:1, :CPU_ROWS].clone())
    small_cpu = manip_env(x[:1, :CPU_ROWS].cpu(), ids[:1, :CPU_ROWS].cpu())
    cases = manip_cases(T)
    worst, bad_b = {}, []
    with torch.no_grad():
        for group, names, fn in cases:
            for d in ("x", "xb"):
                tol = TOL_BF16 if d == "xb" else TOL_F32
                same, e = outputs_err(fn(small, d), fn(small_cpu, d))
                worst[f"{group}_{d}"] = e
                if not same or e > tol:
                    bad_b.append((group, d, same, e))
            for d in ("x", "xb"):
                ms[f"breadth_{group}_{d}"] = wall_ms(
                    lambda fn=fn, d=d: fn(full, d), reps=1)
        covered = {n for _, names, _ in cases for n in names}
        stats = sampler_stats(T, SAMPLER_DRAWS)
        xs = torch.randn(CPU_ROWS, CPU_ROWS, device=dev, generator=gen)
    dbl = outputs_err(double_backward(tpt, xs), double_backward(tpt,
                                                                 xs.cpu()))
    ridx = torch.tensor([3, 1, 3])
    with torch.no_grad():
        alias = outputs_err(alias_calls(tpt, xs, ridx.to(dev)),
                            alias_calls(tpt, xs.cpu(), ridx))
    missing = sorted(set(T.manipulation.__all__) - covered)
    # an assert left behind by any call above would fail this launch
    torch.cuda.synchronize()
    float((torch.ones(8, device=dev) * 2).sum())
    peak = torch.cuda.max_memory_allocated()
    log(f"bert-ragged: BERT-base (bf16) over {bsz} sentences of "
        f"{RAGGED_MIN}-{s_len} tokens ({int(lens_np.sum())} in all) padded "
        f"to {bsz} x {s_len}: {fwd_launches} masked forward launches, "
        f"backward launches {launches}, gradients finite {grads_finite}; "
        f"card vs CPU max scaled err {max(e for _, e in errs.values()):.3g}"
        f" (tol {TOL_F32:g}){'; differ: ' + str(bad) if bad else ''}; "
        f"unpad(pad(x)) bitwise {round_trip}; embedding_bag mean vs the "
        f"pooled lookup {bag_err:.3g}; planted faults told apart {caught}")
    log(f"breadth: {len(cases)} groups over {len(covered)} manipulation "
        f"names, card vs CPU ({CPU_ROWS} rows) max scaled err {worst}"
        f"{'; differ: ' + str(bad_b) if bad_b else ''}; samplers "
        f"({SAMPLER_DRAWS} draws) {stats}; double backward card vs CPU "
        f"{dbl}; top-level aliases card vs CPU {alias}; ms {ms}; peak "
        f"{peak} bytes [{power}]")
    # the backward replays each remat layer's forward
    want = {"flash_attention_fwd_masked": cfg.num_layers * (1 + cfg.remat),
            "flash_attention_bwd_dq_masked": cfg.num_layers,
            "flash_attention_bwd_dkv_masked": cfg.num_layers}
    if fwd_launches != cfg.num_layers or launches != want:
        fail(f"bert-ragged: launches {fwd_launches}, {launches}: want "
             f"{cfg.num_layers} in the forward, then {want}")
    if bad or bad_b or not round_trip or bag_err > TOL_F32 or \
            not grads_finite:
        fail(f"bert-ragged: card vs CPU {bad} {bad_b}, round trip "
             f"{round_trip}, bag {bag_err}, gradients {grads_finite}")
    if not all(caught.values()):
        fail(f"bert-ragged: a planted fault passes the check: {caught}")
    if missing or not all(r[1] for r in stats):
        fail(f"breadth: names not run {missing}, samplers {stats}")
    if not dbl[0] or dbl[1] > TOL_F32 or not alias[0] or alias[1] > TOL_F32:
        fail(f"breadth: double backward {dbl}, aliases {alias}")
    row = {"ms": ms, "peak_bytes": peak,
           "tokens": int(lens_np.sum()),
           "cpu_max_scaled_err": max(e for _, e in errs.values()),
           "breadth_err": worst, "embedding_bag_vs_pooled": bag_err,
           "planted_faults_caught": caught,
           "sampler_moments": {r[0]: r[2:4] for r in stats}}
    del model, hidden, hf, x, full
    torch.cuda.empty_cache()
    return row, launches


def sequence_faults(T, F, ties, tl, flat, seg):
    """(outputs_err of the port's tie gradient, card against CPU;
    {fault: outputs_err(the naive call on the card, the port on the
    CPU)}) for the naive calls phase 41 must tell apart."""
    import torch
    n = int(seg.max()) + 2                 # the last segment empty
    x = ties.clone().requires_grad_()
    F.sequence_pool(x, "max", tl).sum().backward()
    xc = ties.cpu().clone().requires_grad_()
    F.sequence_pool(xc, "max", tl.cpu()).sum().backward()
    naive = ties.clone().requires_grad_()
    m = torch.arange(ties.shape[1], device=ties.device)[None, :] < tl[:, None]
    torch.where(m[..., None], naive, -torch.inf).max(dim=1).values.sum(
        ).backward()
    idx = seg[:, None].expand_as(flat)
    empty = torch.full((n, flat.shape[1]), -torch.inf, device=flat.device)
    rows = torch.tensor([2, 0, 2, 5, 2])
    upd = torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3)
    base = torch.zeros(6, 3)
    # the first of each duplicate kept: the last-wins scatter of the
    # reversed updates
    dev = flat.device
    first = T.scatter(base.to(dev), rows.flip(0).to(dev), upd.flip(0).to(dev))
    return outputs_err(x.grad, xc.grad), {
        "torch.max(dim)'s tie gradient": outputs_err(naive.grad, xc.grad),
        "scatter_reduce's include_self for an empty segment": outputs_err(
            empty.scatter_reduce(0, idx, flat, "amax", include_self=True),
            T.segment_max(flat.cpu(), seg.cpu(), num_segments=n)),
        "the first of duplicate indices kept": outputs_err(
            first, T.scatter(base, rows, upd))}


# bench.py's bench_int8_resnet18 leg: B=128 at 224^2, eval, and its gate
INT8_B, INT8_HW = 128, 224
INT8_AGREE = 0.7               # top-1 agreement of int8 with f32, first
INT8_SLICE = 4                 # images of the card-vs-CPU accumulators
TOL_INT8_EPILOGUE = 1e-6       # the fc's f32 epilogue, card vs CPU (rel.)
DEPLOY_SMALL_B = 2             # the Predictor's second batch size
AES_BYTES = 1 << 18            # the host's cipher timed on 256 KiB
CAPTURE_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                   "flash_attention_bwd_dkv", "fused_ce_fwd",
                   "fused_ce_bwd_dh", "fused_ce_bwd_dw",
                   "flash_attention_fwd_masked",
                   "flash_attention_bwd_dq_masked",
                   "flash_attention_bwd_dkv_masked", "flash_attention_dbias")


def kernel_counts(fa, fused_ce):
    """The launch counters of #1-#7 by the kernel table's names."""
    return {"flash_attention_fwd": fa.launches,
            "flash_attention_bwd_dq": fa.launches_dq,
            "flash_attention_bwd_dkv": fa.launches_dkv,
            "flash_attention_fwd_masked": fa.launches_masked,
            "flash_attention_bwd_dq_masked": fa.launches_dq_masked,
            "flash_attention_bwd_dkv_masked": fa.launches_dkv_masked,
            "flash_attention_dbias": fa.launches_dbias,
            "fused_ce_fwd": fused_ce.launches,
            "fused_ce_bwd_dh": fused_ce.launches_dh,
            "fused_ce_bwd_dw": fused_ce.launches_dw}


def reset_counts(fa, fused_ce):
    reset_fa(fa)
    fused_ce.launches = fused_ce.launches_dh = fused_ce.launches_dw = 0


def add_counts(total, fa, fused_ce):
    for k, v in kernel_counts(fa, fused_ce).items():
        total[k] = total.get(k, 0) + v


def int8_resnet18_phase(resnet18, tjit, quant, power):
    """int8-resnet18 (42): bench.py's bench_int8_resnet18 leg.  Returns
    the phase's row."""
    import copy

    import numpy as np
    import torch
    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(0)
    net = resnet18(num_classes=1000, device="cuda")
    net.eval()
    eager, net_q = copy.deepcopy(net), copy.deepcopy(net)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (INT8_B, 3, INT8_HW, INT8_HW)).astype(np.float32), device="cuda")
    with torch.no_grad():
        want = eager(x)
        t0 = time.perf_counter()
        f32 = tjit.to_static(net)
        ref = f32(x)
        torch.cuda.synchronize()
        f32_capture_s = time.perf_counter() - t0
        qnet = quant.convert_to_int8_inference(net_q)
        t0 = time.perf_counter()
        q = tjit.to_static(qnet)
        got = q(x)
        torch.cuda.synchronize()
        q_capture_s = time.perf_counter() - t0
    f32_ok, f32_err = outputs_err(ref, want.cpu())
    f32_bitwise = bool(torch.equal(ref, want))
    # the reference's gate, before any timing
    agree = float((got.argmax(1) == ref.argmax(1)).float().mean())
    if agree < INT8_AGREE:
        fail(f"int8-resnet18: top-1 agreement {agree} < {INT8_AGREE}")
    if not f32_ok or f32_err > TOL_F32:
        fail(f"int8-resnet18: the captured f32 logits are {f32_err} off "
             "the eager ones")
    # the stem's and the fc's int32 accumulators, card against CPU, on a
    # slice of the batch; the fc's input from the eager int8 forward
    xs = x[:INT8_SLICE]
    seen = {}

    def take_fc_input(module, inputs):
        seen["fc"] = inputs[0].detach()
    hook = torch.nn.Module.register_forward_pre_hook(qnet.fc, take_fc_input)
    with torch.no_grad():
        type(qnet).forward(qnet, xs)
        hook.remove()
        stem_cpu, fc_cpu = (copy.deepcopy(m).to("cpu")
                            for m in (qnet.conv1, qnet.fc))
        acc = {"stem": (qnet.conv1.accumulate(xs),
                        stem_cpu.accumulate(xs.cpu())),
               "fc": (qnet.fc.accumulate(seen["fc"]),
                      fc_cpu.accumulate(seen["fc"].cpu()))}
        bitwise = {k: bool(torch.equal(c[0].cpu(), h[0]))
                   and float(c[1]) == float(h[1])
                   for k, (c, h) in acc.items()}
        out_cpu = fc_cpu(seen["fc"].cpu())
        epi_err = rel(qnet.fc(seen["fc"]).cpu(), out_cpu)
        # planted faults: a flipped code in the stem, the fc's scales 1 %
        # off; each must fail the card-vs-CPU check it would slip past
        bad_stem = copy.deepcopy(qnet.conv1)
        codes = bad_stem._w_q.clone()
        codes[0, 0, 3, 3] = -codes[0, 0, 3, 3] if int(
            codes[0, 0, 3, 3]) else 1
        bad_stem._w_q = codes
        bad_fc = copy.deepcopy(qnet.fc)
        bad_fc._w_scale = bad_fc._w_scale * 1.01
        caught = {
            "a flipped stem code": not torch.equal(
                bad_stem.accumulate(xs)[0].cpu(), acc["stem"][1][0]),
            "the fc's scales 1 % off": rel(bad_fc(seen["fc"]).cpu(),
                                           out_cpu) > TOL_INT8_EPILOGUE}
    if not all(bitwise.values()) or epi_err > TOL_INT8_EPILOGUE:
        fail(f"int8-resnet18: accumulators card vs CPU {bitwise}, fc "
             f"epilogue {epi_err}")
    if not all(caught.values()):
        fail(f"int8-resnet18: a planted fault passes the check: {caught}")
    with torch.no_grad():
        eager_ms = cuda_ms(lambda: eager(x), reps=5, warmup=1)
        f32_ms = cuda_ms(lambda: f32(x), reps=5, warmup=1)
        q_ms = cuda_ms(lambda: q(x), reps=5, warmup=1)
    captures = (f32.forward.captures, q.forward.captures)
    if captures != (1, 1):
        fail(f"int8-resnet18: {captures} captures at one signature")
    peak = torch.cuda.max_memory_allocated()
    row = {"top1_agreement": agree, "f32_captured_vs_eager_err": f32_err,
           "f32_captured_bitwise": f32_bitwise,
           "accumulators_bitwise": bitwise, "fc_epilogue_err": epi_err,
           "planted_faults_caught": caught, "eager_f32_ms": eager_ms,
           "f32_ms": f32_ms, "int8_ms": q_ms,
           "f32_images_per_s": INT8_B / f32_ms * 1e3,
           "int8_images_per_s": INT8_B / q_ms * 1e3,
           "int8_vs_f32": f32_ms / q_ms, "f32_capture_s": f32_capture_s,
           "int8_capture_s": q_capture_s, "peak_bytes": peak}
    log(f"int8-resnet18: ResNet-18, 1,000 classes, B={INT8_B} at "
        f"{INT8_HW}^2, eval; top-1 agreement {agree:.4f} (gate "
        f"{INT8_AGREE}); captured f32 vs eager {f32_err:.3e} (bitwise "
        f"{f32_bitwise}); stem / fc int32 accumulators card vs CPU on "
        f"{INT8_SLICE} images bitwise {bitwise}, fc epilogue {epi_err:.3e}; "
        f"planted faults told apart {caught}; eager f32 {eager_ms:.3f} ms, "
        f"captured f32 {f32_ms:.3f} ms ({row['f32_images_per_s']:.1f} "
        f"images/s), int8 {q_ms:.3f} ms ({row['int8_images_per_s']:.1f} "
        f"images/s), int8 / f32 speed {row['int8_vs_f32']:.4f}; captures "
        f"{f32_capture_s:.2f} s / {q_capture_s:.2f} s; peak {peak} bytes "
        f"[{power}]")
    del net, eager, net_q, qnet, f32, q, x, want, ref, got
    torch.cuda.empty_cache()
    return row


def loss_layer(tnn, gpt, gpt_loss):
    """A layer holding ``gpt`` whose forward is ``gpt_loss`` of its batch:
    a capture of it takes the GPT's parameters as inputs."""
    class Loss(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.gpt = gpt

        def forward(self, ids):
            return gpt_loss(self.gpt, ids, ids)
    return Loss()


def gpt_deploy_phase(base, tnn, gpt_loss, set_flags, fa, fused_ce, tjit,
                     InputSpec, inference, power):
    """gpt-deploy (43) on phase 3's GPT-2 345M in bf16 (``base``, left as
    it is).  Returns (the phase's row, launch counts)."""
    import copy
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    torch.cuda.reset_peak_memory_stats()
    n_layers = base.config.num_layers
    ids = torch.as_tensor(np.random.default_rng(43).integers(
        0, base.config.vocab_size, (B, S)), device=base.wte.device)
    launches, errs = {}, {}
    # 1. the eval logits captured, against eager
    with torch.no_grad():
        want = base(ids)
        model = tjit.to_static(copy.deepcopy(base))
        reset_counts(fa, fused_ce)
        t0 = time.perf_counter()
        got = model(ids)
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
        cap_fwd = fa.launches
        add_counts(launches, fa, fused_ce)
        errs["logits"] = grad_err(got, want)[0]
        logits_bitwise = bool(torch.equal(got, want))
        model(ids)
        one = model.forward.captures
        half = model(ids[:4])
        two = model.forward.captures
        errs["logits_b4"] = grad_err(half, base(ids[:4]))[0]
        eager_ms = cuda_ms(lambda: base(ids), reps=3, warmup=1)
        cap_ms = cuda_ms(lambda: model(ids), reps=3, warmup=1)
    del got, half
    if cap_fwd != n_layers or (one, two) != (1, 2) or \
            max(errs.values()) > TOL_BF16:
        fail(f"gpt-deploy: {cap_fwd} #1 launches in the captured forward, "
             f"captures {one} then {two}")
    # 2. gpt_loss forward + backward captured, unfused and fused
    loss_rows = {}
    for fused in (False, True):
        set_flags({"gpt_fused_ce": fused})
        try:
            loss_e = gpt_loss(base, ids, ids)
            loss_e.backward()
            ge = {n: p.grad for n, p in base.named_parameters()}
            base.zero_grad(set_to_none=True)
            net = tjit.to_static(loss_layer(tnn, base, gpt_loss))
            reset_counts(fa, fused_ce)
            t0 = time.perf_counter()
            loss_c = net(ids)
            loss_c.backward()
            torch.cuda.synchronize()
            loss_s = time.perf_counter() - t0
            got_l = kernel_counts(fa, fused_ce)
            add_counts(launches, fa, fused_ce)
        finally:
            set_flags({"gpt_fused_ce": False})
        g_err = max(grad_err(p.grad, ge[n])[0]
                    for n, p in base.named_parameters())
        base.zero_grad(set_to_none=True)
        want_l = {"flash_attention_fwd": n_layers,
                  "flash_attention_bwd_dq": n_layers,
                  "flash_attention_bwd_dkv": n_layers,
                  "fused_ce_fwd": int(fused), "fused_ce_bwd_dh": int(fused),
                  "fused_ce_bwd_dw": int(fused)}
        if any(got_l[k] != v for k, v in want_l.items()):
            fail(f"gpt-deploy: launches inside the captured loss "
                 f"(fused={fused}) {got_l}, want {want_l}")
        loss_rows[f"fused_{fused}"] = {
            "loss_eager": float(loss_e.detach()),
            "loss_captured": float(loss_c.detach()),
            "loss_bitwise": bool(torch.equal(loss_c.detach(),
                                             loss_e.detach())),
            "grad_err": g_err, "capture_and_step_s": loss_s}
        if g_err > TOL_GRAD_BF16 or abs(float(loss_c) - float(loss_e)) > \
                TOL_LOSS_BF16:
            fail(f"gpt-deploy: the captured loss (fused={fused}) "
                 f"{loss_rows}")
        del ge, loss_e, loss_c, net
    # 3. jit.save with a dynamic batch, then the Predictor on the card
    d = tempfile.mkdtemp(prefix="gpt_deploy_")
    try:
        prefix = os.path.join(d, "gpt2_345m")
        t0 = time.perf_counter()
        tjit.save(base, prefix, input_spec=[InputSpec([None, S], "int64")])
        save_s = time.perf_counter() - t0
        nbytes = {ext: os.path.getsize(prefix + ext)
                  for ext in (".pdparams", ".pdmodel")}
        t0 = time.perf_counter()
        pred = inference.create_predictor(inference.Config(prefix))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    handle = pred.get_input_handle(pred.get_input_names()[0])
    served = {}
    with torch.no_grad():
        for b in (B, DEPLOY_SMALL_B):
            handle.copy_from_cpu(ids[:b].cpu().numpy())
            reset_counts(fa, fused_ce)
            pred.run()
            torch.cuda.synchronize()
            n_fwd = fa.launches
            add_counts(launches, fa, fused_ce)
            out = pred.get_output_handle(pred.get_output_names()[0])._tensor
            ref_b = want if b == B else base(ids[:b])
            served[b] = {"launches": n_fwd,
                         "err": grad_err(out, ref_b)[0],
                         "bitwise": bool(torch.equal(out, ref_b))}
            if n_fwd != n_layers or served[b]["err"] > TOL_BF16:
                fail(f"gpt-deploy: the Predictor at B={b}: {served[b]}")
        handle.copy_from_cpu(ids.cpu().numpy())
        run_ms = cuda_ms(pred.run, reps=3, warmup=1)
        # planted: one weight of the artifact perturbed
        layer = pred._layer
        k = layer._meta["names"].index("lnf_w")
        params = list(layer._params)
        params[k] = params[k] * 1.05
        bad = tjit.TranslatedLayer(layer._program, params, layer._meta)
        small = ids[:DEPLOY_SMALL_B]
        caught = {"one weight 5 % off": grad_err(
            bad(small), base(small))[0] > TOL_BF16}
    if not all(caught.values()):
        fail(f"gpt-deploy: a planted fault passes the check: {caught}")
    peak = torch.cuda.max_memory_allocated()
    row = {"export_s": export_s, "save_s": save_s, "load_s": load_s,
           "file_bytes": nbytes, "logits_err": errs,
           "logits_bitwise": logits_bitwise, "captures": [one, two],
           "eager_forward_ms": eager_ms, "captured_forward_ms": cap_ms,
           "loss": loss_rows, "served": served,
           "predictor_run_ms": run_ms,
           "predictor_tokens_per_s": B * S / run_ms * 1e3,
           "planted_faults_caught": caught, "peak_bytes": peak}
    log(f"gpt-deploy: GPT-2 345M (bf16), B={B}, S={S}: to_static logits "
        f"vs eager {errs['logits']:.3e} (bitwise {logits_bitwise}), B=4 "
        f"{errs['logits_b4']:.3e}, captures {one} then {two}, {cap_fwd} #1 "
        f"launches in the captured forward; eager {eager_ms:.3f} ms, "
        f"captured {cap_ms:.3f} ms a forward; gpt_loss captured, forward "
        f"+ backward: {loss_rows}; jit.save {save_s:.2f} s "
        f"({nbytes} bytes), export {export_s:.2f} s (the to_static "
        f"capture), load {load_s:.2f} s; Predictor {served}, "
        f"{run_ms:.3f} ms a run at B={B}; planted faults told apart "
        f"{caught}; launches {launches}; peak {peak} bytes [{power}]")
    del model, pred, bad, want
    torch.cuda.empty_cache()
    return row, launches


def dy2static_cases(P):
    """Three cases of tests/test_dy2static.py over namespace P: a tensor
    ``if``, a ``while`` bounded by a tensor, a ``for range`` with a tensor
    bound."""
    def if_tensor(x):
        y = x * 2
        if P.mean(x) > 0:
            y = y + 1
        else:
            y = y - 1
        return y

    def while_tensor(x):
        s = P.zeros([1])
        i = P.zeros([1])
        while P.sum(s) < 10.0:
            s = s + x
            i = i + 1
        return i

    def for_range(x, n):
        acc = P.zeros_like(x)
        for i in range(n):
            acc = acc + x * float(1.0)
        return acc
    return [(if_tensor, ([1.0, 2.0],)), (if_tensor, ([-1.0, -2.0],)),
            (while_tensor, ([3.0],)), (for_range, ([1.0, 1.0, 1.0], 5))]


def control_flow(S, P, x, k):
    """Every static.nn function on tensor x and index k."""
    c = S.cond(P.mean(x) > 0, lambda: x * 2, lambda: x - 1)
    i, acc = S.while_loop(lambda i, a: P.sum(a) < 20.0,
                          lambda i, a: [i + 1, a + x + 1],
                          [P.zeros([1]), x * 0])
    cs = S.case([(P.mean(x) > 5, lambda: x * 10),
                 (P.mean(x) > 0, lambda: x + 100)], default=lambda: -x)
    sw = S.switch_case(k, {0: lambda: x + 1, 3: lambda: x * 3},
                       default=lambda: x * 0)
    return c, i, acc, cs, sw


def capture_breadth_phase(tpt, tnn, tjit, static, inference, crypto, fa,
                          fused_ce, power):
    """capture-breadth (44).  Returns (the phase's row, launch counts)."""
    import copy
    import functools
    import os
    import shutil
    import tempfile

    import torch

    from paddle_tpu_torch.jit.dy2static import convert_to_static
    torch.cuda.reset_peak_memory_stats()
    bf16 = torch.bfloat16
    launches = {}
    # 1. dy2static and static.nn, captured on the card against the CPU
    flow = {}
    for n_case, (f, args) in enumerate(dy2static_cases(tpt)):
        card = [torch.tensor(a, device="cuda") if isinstance(a, list)
                else torch.tensor(a, dtype=torch.int32, device="cuda")
                for a in args]
        got = tjit.to_static(f)(*card)
        tpt.set_device("cpu")
        try:
            want = convert_to_static(f)(
                *[torch.tensor(a) if isinstance(a, list) else a
                  for a in args])
        finally:
            tpt.set_device("cuda")
        flow[f"{f.__name__}_{n_case}"] = outputs_err(got, want)
    for k in (0, 3, 7):
        x = torch.tensor([1.0, 2.0])
        sf = tjit.to_static(functools.partial(control_flow, static.nn, tpt))
        got = sf(x.cuda(), torch.tensor(k, dtype=torch.int32, device="cuda"))
        tpt.set_device("cpu")
        try:
            want = control_flow(static.nn, tpt, x, torch.tensor(
                k, dtype=torch.int32))
        finally:
            tpt.set_device("cuda")
        flow[f"static_nn_{k}"] = outputs_err(list(got), list(want))
    bad = {k: v for k, v in flow.items() if not v[0] or v[1] > 0}
    if bad:
        fail(f"capture-breadth: control flow card vs CPU {bad}")
    # 2. the learned-bias encoder captured: forward + backward, #4 inside
    torch.manual_seed(44)
    enc = biased_encoder(tnn, 768, BERT_HEADS, 3072, 2, BERT_S,
                         None).to(bf16)
    with torch.no_grad():
        enc.bias.normal_(0.0, 0.5)
    x = torch.randn(8, BERT_S, 768, device="cuda").to(bf16)
    enc_c = tjit.to_static(copy.deepcopy(enc))
    enc(x).float().pow(2).mean().backward()
    reset_counts(fa, fused_ce)
    enc_c(x).float().pow(2).mean().backward()
    torch.cuda.synchronize()
    got_l = kernel_counts(fa, fused_ce)
    add_counts(launches, fa, fused_ce)
    want_l = {k: 2 for k in ("flash_attention_fwd_masked",
                             "flash_attention_bwd_dq_masked",
                             "flash_attention_bwd_dkv_masked",
                             "flash_attention_dbias")}
    if any(got_l[k] != v for k, v in want_l.items()):
        fail(f"capture-breadth: launches in the captured encoder {got_l}")
    eg = dict(enc.named_parameters())
    dbias_err = grad_err(enc_c.bias.grad, enc.bias.grad)[0]
    enc_err = max(grad_err(p.grad, eg[n].grad)[0]
                  for n, p in enc_c.named_parameters())
    if dbias_err > TOL_DBIAS_BF16 or enc_err > TOL_GRAD_BF16:
        fail(f"capture-breadth: captured encoder gradients {enc_err}, "
             f"dbias {dbias_err}")
    del enc, enc_c, x
    # 3. an encrypted artifact through the Predictor on the card
    torch.manual_seed(45)
    mlp = tnn.Sequential(tnn.Linear(64, 256), tnn.ReLU(),
                         tnn.Linear(256, 10))
    xm = torch.randn(16, 64)
    key = "capture-breadth-key"
    d = tempfile.mkdtemp(prefix="capture_breadth_")
    raised = {}
    try:
        prefix = os.path.join(d, "mlp")
        tjit.save(mlp, prefix, input_spec=[static.InputSpec([None, 64])],
                  encrypt_key=key)
        heads = []
        for ext in (".pdparams", ".pdmodel"):
            with open(prefix + ext, "rb") as f:
                heads.append(f.read(5) == crypto._MAGIC)
        cfg = inference.Config(prefix + ".pdmodel", prefix + ".pdparams")
        cfg.set_cipher_key(key)
        pred = inference.create_predictor(cfg)
        pred.get_input_handle("input_0").copy_from_cpu(xm.numpy())
        pred.run()
        out = pred.get_output_handle("output_0")._tensor
        with torch.no_grad():
            enc_bitwise = bool(torch.equal(out, mlp(xm.cuda())))
        for what, k in (("missing key", None), ("wrong key", "wrong")):
            try:
                tjit.load(prefix, decrypt_key=k)
                raised[what] = False
            except ValueError:
                raised[what] = True
        with open(prefix + ".pdparams", "rb") as f:
            blob = bytearray(f.read())
        blob[40] ^= 0xFF
        with open(prefix + ".pdparams", "wb") as f:
            f.write(bytes(blob))
        try:
            tjit.load(prefix, decrypt_key=key)
            raised["tampered byte"] = False
        except ValueError:
            raised["tampered byte"] = True
        # an artifact captured on the CPU, moved to the card by the load
        mlp_cpu = copy.deepcopy(mlp).to("cpu")
        tjit.save(mlp_cpu, prefix + "_cpu",
                  input_spec=[static.InputSpec([None, 64])])
        moved = tjit.load(prefix + "_cpu", device="cuda")
        with torch.no_grad():
            moved_ok, moved_err = outputs_err(moved(xm.cuda()), mlp_cpu(xm))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if not (all(heads) and enc_bitwise and all(raised.values())):
        fail(f"capture-breadth: encrypted round trip: ciphertext {heads}, "
             f"bitwise {enc_bitwise}, raised {raised}")
    if moved.device.type != "cuda" or not moved_ok or moved_err > TOL_F32:
        fail(f"capture-breadth: a CPU artifact on the card: {moved_err}")
    # the pure-Python cipher's rate on the host
    cipher, kb = tjit._cipher_for(key)
    payload = os.urandom(AES_BYTES)
    t0 = time.perf_counter()
    blob = cipher.encrypt(payload, kb)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = cipher.decrypt(blob, kb)
    dec_s = time.perf_counter() - t0
    if back != payload:
        fail("capture-breadth: the cipher does not round-trip")
    # 4. ROADMAP's two repaired faults, on the card
    nan = float("nan")
    u = tpt.unique(torch.tensor([3.0, nan, 1.0, nan], device="cuda"),
                   return_index=True, return_inverse=True,
                   return_counts=True)
    unique_ok = (u[0][:2].tolist() == [1.0, 3.0] and bool(u[0][2].isnan())
                 and u[0].numel() == 3 and u[1].tolist() == [2, 0, 1]
                 and u[2].tolist() == [1, 2, 0, 2]
                 and u[3].tolist() == [1, 1, 2])
    v = torch.randn(4, 5, device="cuda")
    ns_ok = (tpt.optimizer.AdamW.__name__ == "AdamW"
             and bool(torch.equal(tpt.linalg.norm(v), torch.linalg.norm(v)))
             and tpt.framework.save is tpt.save)
    if not (unique_ok and ns_ok):
        fail(f"capture-breadth: unique of NaNs {u}, namespace {ns_ok}")
    peak = torch.cuda.max_memory_allocated()
    row = {"control_flow_err": {k: v[1] for k, v in flow.items()},
           "encoder_grad_err": enc_err, "encoder_dbias_err": dbias_err,
           "encrypted_bitwise": enc_bitwise, "raised": raised,
           "cpu_artifact_on_card_err": moved_err,
           "aes_encrypt_mb_per_s": AES_BYTES / enc_s / 1e6,
           "aes_decrypt_mb_per_s": AES_BYTES / dec_s / 1e6,
           "unique_nan_ok": unique_ok, "namespace_ok": ns_ok,
           "peak_bytes": peak}
    log(f"capture-breadth: dy2static and static.nn captured on the card vs "
        f"the CPU {row['control_flow_err']}; the learned-bias encoder (2 "
        f"layers of BERT-base's width, bf16, B=8, S={BERT_S}) captured: "
        f"launches {got_l}, gradients vs eager {enc_err:.3e}, dbias "
        f"{dbias_err:.3e}; an encrypted artifact through the Predictor "
        f"bitwise {enc_bitwise}, raised {raised}; a CPU-captured artifact "
        f"moved to the card at load {moved_err:.3e} off the CPU; the host's "
        f"AES-CTR + "
        f"HMAC {row['aes_encrypt_mb_per_s']:.4f} MB/s encrypt, "
        f"{row['aes_decrypt_mb_per_s']:.4f} MB/s decrypt; unique keeps one "
        f"NaN {unique_ok}; the namespace {ns_ok}; peak {peak} bytes "
        f"[{power}]")
    torch.cuda.empty_cache()
    return row, launches


# -- the data-parallel user surface (phases 45-47) ----------------------------
# fleet-gpt (45): four runs through fleet at world size 1 (plain dp and
# sharding stages 1-3); dp = 2 simulated at ZERO_DP2_LAYERS layers in f32
# with SGD, whose moves scale with the gradients (Adam's do not: a gradient
# summed over the ranks instead of averaged would move it the same)
FLEET_RUNS = (("dp", None), ("sharding1", 1), ("sharding2", 2),
              ("sharding3", 3))
DP2_LR = 0.1
# dp = 2 against one-rank TrainStep on the global batch, f32: a loss within
# TOL_DP2_LOSS, the parameters within TOL_DP2_MOVE of the whole move (max
# |error| over the largest leaf's largest move).  Each weight gradient sums
# 8192 tokens' terms, which the two ranks add as two halves of 4096: on
# the H100 the first step reads 3.2e-6 of the whole move, and the two
# trajectories then part (2.8e-5 after the second step, 2.2e-5 after the
# third).  Per leaf the error reaches 5e-4 of the leaf's own move in the
# LayerNorm gains, whose moves are about 4 % of the largest leaf's and
# whose gradients cancel over the tokens: the per-leaf reading is logged,
# not held.  The planted fault (the ranks' gradients summed, not
# averaged) moves every parameter twice as far, 1.0 of the whole move,
# and the check reads it on each run
TOL_DP2_LOSS = 1e-4
TOL_DP2_MOVE = 1e-3
# dp-meta (46): LocalSGD k = 2 from begin_step = 3 with AdamW(1e-4); DGC
# with SGD(0.1) (a CPU run of this model at S=64 fell 11.04 -> 7.43 over
# four such steps), sparsity 0.999 after one dense step
LOCALSGD_STEPS, DGC_STEPS, DGC_LR = 6, 4, 0.1
# syncbn (47): ResNet-50 at 2 x 32 (224^2) against one rank's 64; the
# small ResNet in f64 at 2 x 4 (64^2).  The two forwards sum each of 53
# batch norms' statistics in another order (two halves, then their sum)
# and cuDNN may choose other f32 convolution algorithms at B=32 and B=64,
# so the logits of a random ResNet-50 carry more rounding than resnet18's
# card-vs-CPU forward (TOL_VISION_F32's); normalising by each rank's own
# slice instead moves them by O(1), and the check reads that on each run
SYNCBN_B, SYNCBN_HW = 32, 224
TOL_SYNCBN_F32 = 1e-3
# The small ResNet's f64 gradients (an SGD(1.0) move, per leaf against the
# leaf's move): batch norm accumulates its statistics in f32 whatever the
# input's dtype (the reference's _mean_var_1pass), so the global batch's
# statistics summed over two ranks differ from one rank's in f32 rounding;
# the H100 read 8.7e-7 (a CPU run 7.5e-7), each rank's own statistics 1.4
# (1.6), and the check reads the latter on each run
TOL_SYNCBN_F64 = 1e-4


def _snap(model):
    import torch
    with torch.no_grad():
        return {n: p.detach().clone() for n, p in model.named_parameters()}


def _reset(model, init):
    import torch
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])


def _flash_launches(fa):
    c = fa_counts(fa)
    return {"flash_attention_fwd": c[0], "flash_attention_bwd_dq": c[1],
            "flash_attention_bwd_dkv": c[2]}


def _add(total, extra):
    for k, v in extra.items():
        total[k] = total.get(k, 0) + v


def fleet_gpt_phase(cfg, ids_t, fa, want_losses, want_params, power):
    """Phase 45: GPT-2 345M through fleet (collective mode) at world size 1
    over NCCL, then dp = 2 simulated.  Returns the readings and #1-#3's
    launches."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import GPT, gpt_loss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainStep, set_mesh
    L = cfg.num_layers
    launches, row = {}, {}
    model = GPT(cfg, device="cuda")                  # f32 masters, seed 0
    init = _snap(model)
    pbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"fleet-gpt: GPT-2 345M, fleet.init(is_collective=True) at world "
        f"size 1, amp O2 bf16 (use_pure_fp16), AdamW(learning_rate=1e-4), "
        f"B={B}, S={S}, {TRAIN_STEPS} steps a run, against the train "
        "phase's TrainStep trajectory")
    try:
        for name, stage in FLEET_RUNS:
            s = fleet.DistributedStrategy()
            s.amp = True
            s.amp_configs = {"use_pure_fp16": True}
            if stage is not None:
                s.sharding = True
                s.sharding_configs = {"sharding_degree": 1, "stage": stage}
            fleet.init(is_collective=True, strategy=s)
            _reset(model, init)
            fleet.distributed_optimizer(AdamW(learning_rate=1e-4))
            step = fleet.train_step(model, gpt_loss)
            if not isinstance(step, ShardedTrainStep) or \
                    step.sharding_stage != (stage or 0):
                fail(f"fleet-gpt {name}: fleet built {type(step).__name__} "
                     f"stage {getattr(step, 'sharding_stage', None)}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() - pbytes
            reset_fa(fa)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            losses, counts = [], []
            for i in range(TRAIN_STEPS):
                if i == 1:
                    e0.record()
                losses.append(step(ids_t, ids_t))
                counts.append(fa_counts(fa)[:3])
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / (TRAIN_STEPS - 1)
            peak = torch.cuda.max_memory_allocated() - held
            step.gather_params()
            losses = [float(x) for x in losses]
            want = [(L * (i + 1),) * 3 for i in range(TRAIN_STEPS)]
            if counts != want:
                fail(f"fleet-gpt {name}: flash launches {counts} != {want}")
            _add(launches, _flash_launches(fa))
            if losses != want_losses:
                fail(f"fleet-gpt {name}: losses {losses} are not the train "
                     f"phase's {want_losses}")
            diff = [n for n, p in model.named_parameters()
                    if not torch.equal(p.detach().cpu(), want_params[n])]
            if diff:
                fail(f"fleet-gpt {name}: parameters {diff} differ from the "
                     "train phase's")
            row[name] = {"losses": losses, "step_ms": ms,
                         "tokens_per_s": B * S / ms * 1e3,
                         "peak_bytes": peak,
                         "opt_state_bytes_per_replica":
                             step.opt_state_bytes_per_replica(),
                         "applied_meta_list": fleet.applied_meta_list()}
            log(f"fleet-gpt {name}: {fleet.applied_meta_list()}, losses and "
                f"parameters bitwise the train phase's; step {ms:.3f} ms, "
                f"{B * S / ms * 1e3:.1f} training tokens/s, "
                f"max_memory_allocated {peak} bytes, optimizer state "
                f"{row[name]['opt_state_bytes_per_replica']} bytes a "
                f"replica; flash launches {counts[-1]} [{power}]")
            del step
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        set_mesh(None)
    del model, init
    torch.cuda.empty_cache()

    dp2_rows, dp2_launch = fleet_dp2(cfg, ids_t, fa, power)
    row["dp2"] = dp2_rows
    _add(launches, dp2_launch)
    return row, launches


def _move_errs(got, want, init):
    """The error of the parameters ``got`` against ``want``, both moved
    from ``init``: per leaf, max |got - want| over that leaf's max move;
    and over the whole move, max |got - want| over the largest leaf's max
    move."""
    moves = {n: float((want[n] - init[n]).abs().max()) for n in want}
    diffs = {n: float((got[n] - want[n]).abs().max()) for n in want}
    per = {n: diffs[n] / max(moves[n], 1e-30) for n in want}
    return per, max(diffs.values()) / max(moves.values()), moves


def fleet_dp2(cfg, ids_t, fa, power):
    """Phase 45's second part: dp = 2 simulated (LoopbackWorld) at GPT-2's
    width and ZERO_DP2_LAYERS layers in f32 with SGD, stages 0-3 bitwise
    one another and against one-rank TrainStep on the global batch, step
    by step; the planted summed gradients.  Returns the readings and
    #1-#3's launches."""
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPT, GPTConfig, gpt_loss
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel import LoopbackWorld, ShardedTrainStep
    launches = {}
    cfg2 = GPTConfig(hidden_size=cfg.hidden_size, num_heads=cfg.num_heads,
                     vocab_size=cfg.vocab_size, max_seq_len=cfg.max_seq_len,
                     num_layers=ZERO_DP2_LAYERS, remat=False)
    one = GPT(cfg2, device="cuda")
    init2 = _snap(one)
    ts = TrainStep(one, gpt_loss, SGD(learning_rate=DP2_LR))
    want_l, want_steps = [], []
    for _ in range(ZERO_DP2_STEPS):
        want_l.append(float(ts(ids_t, ids_t)))
        want_steps.append(_snap(one))
    want_p = want_steps[-1]
    del ts, one
    models2 = [GPT(cfg2, device="cuda") for _ in range(2)]

    class SummedGrads(ShardedTrainStep):
        """A planted fault: the ranks' means summed, not averaged."""

        def _mean(self, t):
            return super()._mean(t) * self._nd

    def dp2(stage, cls=ShardedTrainStep, trace=False):
        for m in models2:
            _reset(m, init2)

        def rank_fn(rank, mesh):
            step = cls(models2[rank], gpt_loss, SGD(learning_rate=DP2_LR),
                       mesh=mesh, sharding_stage=stage)
            losses, steps = [], []
            for _ in range(ZERO_DP2_STEPS):
                losses.append(float(step(ids_t, ids_t)))
                if trace and rank == 0:
                    step.gather_params()
                    steps.append(_snap(models2[rank]))
            step.gather_params()
            return losses, _snap(models2[rank]), steps
        reset_fa(fa)
        t0 = time.perf_counter()
        out = LoopbackWorld(2).run(rank_fn)
        wall = (time.perf_counter() - t0) / ZERO_DP2_STEPS
        if fa_counts(fa)[:3] != (2 * ZERO_DP2_STEPS * ZERO_DP2_LAYERS,) * 3:
            fail(f"fleet-gpt dp=2 stage {stage}: flash launches "
                 f"{fa_counts(fa)[:3]}")
        _add(launches, _flash_launches(fa))
        for n in out[0][1]:
            if not torch.equal(out[0][1][n], out[1][1][n]):
                fail(f"fleet-gpt dp=2 stage {stage}: the replicas differ "
                     f"at {n}")
        loss_d = max(abs(a - b) for a, b in zip(out[0][0], want_l))
        per, whole, _ = _move_errs(out[0][1], want_p, init2)
        return out[0], loss_d, whole, max(per.values()), wall

    rows = {}
    base = None
    for stage in range(4):
        (losses, params, steps), loss_d, move, leaf, wall = dp2(
            stage, trace=stage == 0)
        if base is None:
            base = (losses, params)
            # where the error sits: per step, the leaf it is largest in
            # (beside that leaf's move against the largest leaf's) and
            # the error over the whole move
            trace_rows = []
            for t, (got, want) in enumerate(zip(steps, want_steps)):
                p_t, w_t, moves = _move_errs(got, want, init2)
                worst = max(p_t, key=p_t.get)
                trace_rows.append({
                    "step": t + 1, "whole_move_err": w_t,
                    "worst_leaf": worst, "worst_leaf_err": p_t[worst],
                    "worst_leaf_move_share": moves[worst]
                    / max(moves.values()),
                    "leaf_errs": p_t})
                log(f"fleet-gpt dp=2 after step {t + 1}: error over the "
                    f"whole move {w_t:.3g}; per leaf at most {p_t[worst]:.3g}"
                    f" in {worst}, whose largest move is "
                    f"{moves[worst] / max(moves.values()):.3g} of the "
                    f"largest leaf's; per leaf {_fmt_errs(p_t)}")
            rows["trace"] = trace_rows
        elif losses != base[0] or any(not torch.equal(params[n], base[1][n])
                                      for n in params):
            fail(f"fleet-gpt dp=2: stage {stage} is not stage 0's bits")
        if loss_d > TOL_DP2_LOSS or move > TOL_DP2_MOVE:
            fail(f"fleet-gpt dp=2 stage {stage}: against one-rank TrainStep "
                 f"on the global batch loss {loss_d:.3g} (limit "
                 f"{TOL_DP2_LOSS}), move {move:.3g} (limit {TOL_DP2_MOVE})")
        rows[f"stage{stage}"] = {"losses": losses, "loss_err": loss_d,
                                 "move_err": move, "worst_leaf_err": leaf,
                                 "wall_ms": wall * 1e3}
        log(f"fleet-gpt dp=2 stage {stage} (simulated, {ZERO_DP2_LAYERS} "
            f"layers, f32, SGD({DP2_LR})): losses {losses}, bitwise stage "
            f"0's; against one-rank TrainStep on the global batch: loss "
            f"{loss_d:.3g}, error over the whole move {move:.3g} (per leaf "
            f"at most {leaf:.3g}); {wall * 1e3:.1f} ms a step (host clock, "
            f"both ranks: the simulation's cost) [{power}]")
    _, loss_f, move_f, _, _ = dp2(0, SummedGrads)
    if not move_f > TOL_DP2_MOVE:
        fail(f"fleet-gpt dp=2: the planted summed gradients read {move_f:.3g},"
             f" not above the limit {TOL_DP2_MOVE}")
    log(f"fleet-gpt dp=2: the planted summed gradients read move "
        f"{move_f:.3g}, loss {loss_f:.3g}: told apart")
    rows["summed_fault_move_err"] = move_f
    del models2, init2, want_p, want_steps
    torch.cuda.empty_cache()
    return rows, launches


def _fmt_errs(errs):
    return "{" + ", ".join(f"{n}: {e:.2g}" for n, e in errs.items()) + "}"


def dp_meta_phase(cfg, ids_t, fa, power):
    """Phase 46: LocalSGDTrainStep and DGCTrainStep on two simulated ranks
    at GPT-2's width (ZERO_DP2_LAYERS layers, f32), with the planted DGC
    that forgets to zero v.  Returns the readings and #1-#3's launches."""
    import torch
    from paddle_tpu_torch.models import GPT, GPTConfig, gpt_loss
    from paddle_tpu_torch.optimizer import SGD, AdamW
    from paddle_tpu_torch.parallel import (DGCTrainStep, LocalSGDTrainStep,
                                           LoopbackWorld)
    cfg2 = GPTConfig(hidden_size=cfg.hidden_size, num_heads=cfg.num_heads,
                     vocab_size=cfg.vocab_size, max_seq_len=S,
                     num_layers=ZERO_DP2_LAYERS, remat=False)
    models = [GPT(cfg2, device="cuda") for _ in range(2)]
    init = _snap(models[0])
    launches, row = {}, {}

    def run(fn, steps):
        for m in models:
            _reset(m, init)
        reset_fa(fa)
        t0 = time.perf_counter()
        out = LoopbackWorld(2).run(fn)
        wall = (time.perf_counter() - t0) / steps
        want = (2 * steps * ZERO_DP2_LAYERS,) * 3
        if fa_counts(fa)[:3] != want:
            fail(f"dp-meta: flash launches {fa_counts(fa)[:3]} != {want}")
        _add(launches, _flash_launches(fa))
        return out, wall

    def localsgd(rank, mesh):
        step = LocalSGDTrainStep(models[rank], gpt_loss,
                                 AdamW(learning_rate=1e-4), mesh=mesh,
                                 k_steps=2, begin_step=3)
        losses, snaps = [], []
        for _ in range(LOCALSGD_STEPS):
            losses.append(float(step(ids_t, ids_t)))
            snaps.append(_snap(models[rank]))
        return losses, snaps
    (r0, r1), wall = run(localsgd, LOCALSGD_STEPS)
    equal = [all(torch.equal(r0[1][i][n], r1[1][i][n]) for n in init)
             for i in range(LOCALSGD_STEPS)]
    # warm-up (step + 1 < 3) averages gradients; then every 2nd step syncs
    want_eq = [True, True, False, True, False, True]
    losses = r0[0]
    if equal != want_eq:
        fail(f"dp-meta LocalSGD: replicas equal after each step {equal} != "
             f"{want_eq}")
    if losses != r1[0] or not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"dp-meta LocalSGD: losses {losses} not finite and falling on "
             "both ranks")
    row["localsgd"] = {"losses": losses, "replicas_equal": equal,
                       "wall_ms": wall * 1e3}
    log(f"dp-meta LocalSGD (k=2, begin_step=3, AdamW(1e-4), f32): losses "
        f"{losses}; replicas bitwise equal after each step {equal}; "
        f"{wall * 1e3:.1f} ms a step (host clock, both ranks) [{power}]")
    del r0, r1

    class Recording(DGCTrainStep):
        """Keeps each tensor's dense result of the last call, in call
        order."""

        def _compress(self, g, u, v, sparsity):
            out = super()._compress(g, u, v, sparsity)
            self.dense.append(out[0])
            return out

    class ForgetsV(Recording):
        """A planted fault: the exchanged entries of v are not zeroed."""

        def _compress(self, g, u, v, sparsity):
            out = super()._compress(g, u, v, sparsity)
            if sparsity <= 0.0:
                return out
            return out[0], out[1], v + (self.momentum * u + g.float())

    def dgc(cls, steps):
        def fn(rank, mesh):
            step = cls(models[rank], gpt_loss, SGD(learning_rate=DGC_LR),
                       mesh=mesh, momentum=0.9, sparsity=[0.999],
                       rampup_begin_step=1)
            names = [n for n, p in models[rank].named_parameters()
                     if p.requires_grad]
            losses, reads = [], []
            for i in range(steps):
                step.dense = []
                losses.append(float(step(ids_t, ids_t)))
                if i == 0:
                    continue
                u, v = step._uv
                zeroed = all(bool((u[n].reshape(-1)[idx] == 0).all()
                                  and (v[n].reshape(-1)[idx] == 0).all())
                             for n, (idx, _) in step.exchanged.items())
                reads.append({"sent": {n: (idx.clone(), val.clone()) for n, (
                    idx, val) in step.exchanged.items()},
                    "dense": dict(zip(names, step.dense)),
                    "zeroed": zeroed})
            return losses, reads
        return run(fn, steps)

    def dgc_faults(ranks):
        """What the checks read, as a list of what is wrong."""
        wrong = []
        for i in range(len(ranks[0][1])):
            sent = [r[1][i]["sent"] for r in ranks]
            for n, dense in ranks[0][1][i]["dense"].items():
                k = DGCTrainStep.top_k(dense.numel(), 0.999)
                if any(s[n][0].numel() != k for s in sent):
                    wrong.append(f"{n}: not {k} entries sent a rank")
                idx = torch.cat([s[n][0] for s in sent])
                val = torch.cat([s[n][1] for s in sent])
                want = torch.zeros(dense.numel(), device=dense.device
                                   ).index_add_(0, idx, val) / 2
                if not torch.equal(dense.reshape(-1), want) or \
                        not torch.equal(dense, ranks[1][1][i]["dense"][n]):
                    wrong.append(f"{n}: dense result not the reconstruction")
            for r, rk in enumerate(ranks):
                if not rk[1][i]["zeroed"]:
                    wrong.append(f"rank {r}: exchanged u or v not zeroed")
        return sorted(set(wrong))

    ranks, wall = dgc(Recording, DGC_STEPS)
    wrong = dgc_faults(ranks)
    losses = ranks[0][0]
    if wrong:
        fail(f"dp-meta DGC: {wrong[:4]}")
    if losses != ranks[1][0] or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"dp-meta DGC: losses {losses} not finite and falling")
    sent = {n: int(s[0].numel()) * 2
            for n, s in ranks[0][1][-1]["sent"].items()}
    row["dgc"] = {"losses": losses, "exchanged_per_step": sent,
                  "wall_ms": wall * 1e3}
    log(f"dp-meta DGC (SGD({DGC_LR}), momentum 0.9, sparsity 0.999 after "
        f"one dense step, f32): losses {losses}; entries exchanged a step "
        f"(k x dp) {sent}; the dense results bitwise the reconstruction "
        f"from both ranks' (values, indices), exchanged u and v zeroed; "
        f"{wall * 1e3:.1f} ms a step [{power}]")
    del ranks
    faulty, _ = dgc(ForgetsV, 2)
    caught = dgc_faults(faulty)
    if not any("not zeroed" in w for w in caught):
        fail("dp-meta: the planted DGC that keeps v was not caught")
    log(f"dp-meta: the planted DGC that forgets to zero v reads {caught}: "
        "told apart")
    row["dgc_fault_caught"] = caught
    del models, init, faulty
    torch.cuda.empty_cache()
    return row, launches


def syncbn_phase(resnet18, resnet50, power):
    """Phase 47: SyncBatchNorm under ShardedTrainStep at simulated dp = 2
    against BatchNorm over the global batch on one rank (ResNet-50, f32
    training forward; resnet18 in f64, gradients); ResNet-50 under
    LocalSGDTrainStep keeps each rank's statistics until a sync, beside the
    planted sync that skips the buffers."""
    import contextlib
    import copy

    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import SyncBatchNorm
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel import (LocalSGDTrainStep, LoopbackWorld,
                                           ShardedTrainStep)
    from paddle_tpu_torch.parallel.mesh import mean_over
    row = {}
    xs, ys = vision_batch(2 * SYNCBN_B, 3, SYNCBN_HW, 1000, seed=3)
    x, y = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    torch.manual_seed(0)
    base = resnet50(device="cuda")
    state = copy.deepcopy(base.state_dict())

    def capture(m, xb, yb):
        out = m(xb)
        capture.logits[id(m)] = out.detach()
        return vision_loss_of(out, yb)
    capture.logits = {}

    def bufs(m):
        return {n: b.detach().clone() for n, b in m.named_buffers()}

    # one rank, BatchNorm over the global 64 (lr 0: the forward's state)
    ts = TrainStep(base, capture, SGD(learning_rate=0.0))
    t0 = time.perf_counter()
    want_loss = ts(x, y)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    want_out, want_bufs = capture.logits[id(base)], bufs(base)
    del ts

    replicas = []
    for _ in range(2):
        m = resnet50(device="cuda")
        m.load_state_dict(state)
        replicas.append(SyncBatchNorm.convert_sync_batchnorm(m))
    n_sync = sum(isinstance(mm, SyncBatchNorm) for mm in
                 replicas[0].modules())

    class LocalStats(ShardedTrainStep):
        """The counterfactual: each rank normalises by its own slice."""

        def _stats(self):
            return contextlib.nullcontext()

    def sharded(cls=ShardedTrainStep):
        for m in replicas:
            m.load_state_dict(state)

        def fn(rank, mesh):
            m = replicas[rank]
            loss = cls(m, capture, SGD(learning_rate=0.0), mesh=mesh)(x, y)
            return loss, capture.logits[id(m)], bufs(m)
        t0 = time.perf_counter()
        out = LoopbackWorld(2).run(fn)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def err(out):
        """{what: scaled_err} of the loss, the logits and the worst running
        statistic, against one rank's."""
        logits = torch.cat([o[1] for o in out])
        return {"loss": scaled_err(out[0][0].cpu(), want_loss.cpu()),
                "logits": scaled_err(logits.cpu(), want_out.cpu()),
                "stats": max(scaled_err(out[0][2][n].cpu(),
                                        want_bufs[n].cpu())
                             for n in want_bufs)}
    out, dp_ms = sharded()
    for n in want_bufs:
        if not torch.equal(out[0][2][n], out[1][2][n]):
            fail(f"syncbn: the ranks' {n} differ")
    f32_parts = err(out)
    f32_err = max(f32_parts.values())
    local, _ = sharded(LocalStats)
    local_err = max(err(local).values())
    log(f"syncbn: ResNet-50 with {n_sync} SyncBatchNorm (convert_sync_"
        f"batchnorm) under ShardedTrainStep at dp=2 (2 x {SYNCBN_B}, "
        f"{SYNCBN_HW}^2, f32) against BatchNorm over the global "
        f"{2 * SYNCBN_B} on one rank: loss, logits and every running stat "
        f"{f32_parts} (limit {TOL_SYNCBN_F32}); each rank's own statistics "
        f"instead read {local_err:.3g}; a step {dp_ms:.1f} ms on two "
        f"simulated ranks (the simulation's cost: the statistic sums cross "
        f"on the host), {one_ms:.1f} ms on one (host clock, first call) "
        f"[{power}]")
    if f32_err > TOL_SYNCBN_F32 or not local_err > TOL_SYNCBN_F32:
        fail("syncbn: the f32 training forward is not the global batch's, "
             "or the rank-local statistics are not told apart")
    row.update({"resnet50_f32_err": f32_parts, "local_stats_err": local_err,
                "resnet50_dp2_step_ms": dp_ms, "resnet50_one_step_ms": one_ms,
                "sync_layers": n_sync})
    del out, local

    # f64 gradients on bench.py's small ResNet, 2 x 4 at 64^2
    xs8, ys8 = vision_batch(2 * 4, 3, SMALL_VISION_HW, 10, seed=4)
    x8 = torch.from_numpy(xs8).cuda().double()
    y8 = torch.from_numpy(ys8).cuda()
    torch.manual_seed(0)
    small = resnet18(num_classes=10, device="cuda").double()
    s_state = copy.deepcopy(small.state_dict())
    old = _snap(small)
    TrainStep(small, vision_loss, SGD(learning_rate=1.0))(x8, y8)
    want_move = {n: p.detach() - old[n] for n, p in small.named_parameters()}
    smalls = []
    for _ in range(2):
        m = resnet18(num_classes=10, device="cuda").double()
        m.load_state_dict(s_state)
        smalls.append(SyncBatchNorm.convert_sync_batchnorm(m))

    def small_dp2(cls):
        """The per-leaf error of the dp = 2 move against one rank's."""
        for m in smalls:
            m.load_state_dict(s_state)
        LoopbackWorld(2).run(lambda r, mesh: cls(
            smalls[r], vision_loss, SGD(learning_rate=1.0), mesh=mesh)(
                x8, y8))
        return max(float(((p.detach() - old[n]) - want_move[n]).abs().max()
                         / want_move[n].abs().max().clamp_min(1e-30))
                   for n, p in smalls[0].named_parameters())
    g_err, g_local = small_dp2(ShardedTrainStep), small_dp2(LocalStats)

    def recompute_refused(rank, mesh):
        try:
            ShardedTrainStep(smalls[rank], vision_loss, SGD(learning_rate=1.0),
                             mesh=mesh, recompute=True)
        except NotImplementedError:
            return True
        return False
    refused = LoopbackWorld(2).run(recompute_refused)
    log(f"syncbn: resnet18 (2 x 4, {SMALL_VISION_HW}^2) in f64 training "
        f"mode (f32 statistics), SyncBatchNorm at dp=2 against BatchNorm "
        f"over 8 on one rank: every gradient (an SGD(1.0) move) within "
        f"{g_err:.3g} of the move (limit {TOL_SYNCBN_F64}); each rank's own "
        f"statistics instead read {g_local:.3g}; recompute=True on the "
        f"simulated ranks refused: {refused}")
    if g_err > TOL_SYNCBN_F64 or not g_local > TOL_SYNCBN_F64:
        fail("syncbn: the f64 gradients are not the global batch's, or the "
             "rank-local statistics are not told apart")
    if refused != [True, True]:
        fail("syncbn: ShardedTrainStep(recompute=True) with batch norms on "
             "simulated ranks on the card was not refused")
    row["resnet18_f64_local_stats_err"] = g_local
    row["resnet18_f64_grad_err"] = g_err
    del small, smalls

    # LocalSGD keeps each rank's statistics until a sync
    class SkipsBuffers(LocalSGDTrainStep):
        """A planted fault: the sync averages the parameters only."""

        def _average_params(self):
            for p in self._params().values():
                p.copy_(mean_over(self.mesh.group, p.detach().float()).to(
                    p.dtype))

    def localsgd(cls):
        for m in replicas:
            m.load_state_dict(state)

        def fn(rank, mesh):
            m = replicas[rank]
            step = cls(m, vision_loss, SGD(learning_rate=0.0), mesh=mesh,
                       k_steps=2, begin_step=1)
            step(x, y)
            first = bufs(m)
            step(x, y)
            return first, bufs(m)
        return LoopbackWorld(2).run(fn)
    ranks = localsgd(LocalSGDTrainStep)
    own_err = 0.0
    for r in range(2):
        m = resnet50(device="cuda")
        m.load_state_dict(state)
        with torch.no_grad():
            m(x[r * SYNCBN_B:(r + 1) * SYNCBN_B])
        own_err = max([own_err] + [scaled_err(ranks[r][0][n].cpu(), b.cpu())
                                   for n, b in m.named_buffers()])
    differ = any(not torch.equal(ranks[0][0][n], ranks[1][0][n])
                 for n in want_bufs)
    synced = all(torch.equal(ranks[0][1][n], ranks[1][1][n])
                 for n in want_bufs)
    skipped = localsgd(SkipsBuffers)
    fault_synced = all(torch.equal(skipped[0][1][n], skipped[1][1][n])
                       for n in want_bufs)
    log(f"syncbn: the same ResNet-50 under LocalSGDTrainStep (k=2): after a "
        f"local step each rank's running stats are its own 32's "
        f"({own_err:.3g} of a lone forward on its slice; the ranks' "
        f"{'differ' if differ else 'are equal'}), after the sync bitwise "
        f"equal: {synced}; the planted sync that skips the buffers leaves "
        f"them equal: {fault_synced}")
    if own_err > TOL_VISION_F32 or not differ or not synced or fault_synced:
        fail("syncbn: LocalSGD's statistics are not the ranks' own until a "
             "sync, or the planted sync that skips the buffers was not "
             "caught")
    row.update({"localsgd_own_stats_err": own_err,
                "localsgd_buffers_synced": synced})
    del replicas, ranks, skipped, base
    torch.cuda.empty_cache()
    return row


# -- tensor and sequence parallelism (phases 48-49) ---------------------------
# Ranks are LoopbackWorld threads on the one card: every time below is the
# simulation's (both ranks' work on one card, and the host hop of the
# functions whose backward is a collective); NCCL at two or more ranks is
# unmeasured.  tp-gpt (48) holds mp = 2 at GPT-2 345M's full width and depth
# to mp = 1 twice.  In f32 the two differ only in the order of their sums:
# the served logits by ||error|| / ||logits|| at TOL_F32, one SGD(DP2_LR)
# step's gathered parameters by TOL_DP2_LOSS / TOL_DP2_MOVE, as the 2-layer
# dp x mp x sp check.  In bf16 that order is rounded through 24 layers: the
# served logits by ||error|| / ||logits|| at TP_LOGITS_NORM (the max |error|
# logged beside it, 4 ulps of the largest logit), TOL_LOSS_BF16 on the loss;
# 3 O2 AdamW(1e-4) steps against the train phase's TrainStep, the losses
# within TOL_LOSS_BF16 and the gathered parameters by the L2 of the move's
# error over the move at TP_MOVE_L2 (the whole-move max logged: Adam
# normalises each gradient entry, so an entry whose bf16 gradient sits
# near 0 may move the other way under another summation order).  Each
# limit sits between the sound reading and a planted fault's: the qkv
# shard cut contiguously instead of by head (serving), copy_to without
# its sum over mp (training; sp-ring's: the gradients' sum over sp
# skipped); each is the geometric mean of the two, one digit, rounded
# down.  On an H100 (700 W): logits 0.0158 (sp = 2 0.0107) against the qkv cut's
# 0.832; the move 0.0638 (sp = 2 0.0497) against the faults' 1.08 (sp
# 0.791); in f32 the logits read 2.5e-6, the SGD step's move 3.4e-5.
TP_STEPS = 3
# tp-gpt, sp-ring and pp-gpt: GPT-2 345M's width at this depth (each rank's
# path is the same at 24; 8 divides by pp = 2 and 4)
PAR_LAYERS = 8
TP_LOGITS_NORM = 0.1
TP_MOVE_L2 = 0.2
# dp = 2 x mp = 2 x sp = 2 (8 threads) at 2 layers of GPT-2's width, f32,
# SGD(DP2_LR), against one-rank TrainStep on the global batch by
# TOL_DP2_LOSS / TOL_DP2_MOVE
TP_3D_AXES = {"dp": 2, "mp": 2, "sp": 2}
# sp-ring (49): bench_longseq_flash's layer, B*H = 8, S = 8192, D = 128,
# causal, bf16, at sp = 2 and 4, held to #1-#3 on the whole sequence: out
# by TOL_BF16 (absolute) and TOL_FWD_BF16 (the relative measure), dq, dk,
# dv by TOL_GRAD_BF16; the planted faults (every chunk causal, a merge
# without the chunks' lse, delta taken from the diagonal chunk's output)
# must read above them
RING_SPS = (2, 4)
RING_REPS = 3


def _tp_counts(fa):
    c = fa_counts(fa)[:3]
    return {"flash_attention_fwd": c[0], "flash_attention_bwd_dq": c[1],
            "flash_attention_bwd_dkv": c[2]}


def _norm_err(got, want):
    """||got - want|| / ||want|| in f32."""
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def _move_l2(got, want, init):
    """||got - want|| / ||want - init|| over every parameter (f32)."""
    num = sum(float((got[n].float() - want[n].float()).pow(2).sum())
              for n in want)
    den = sum(float((want[n].float() - init[n].float()).pow(2).sum())
              for n in want)
    return math.sqrt(num / max(den, 1e-30))


def _contiguous_qkv(model, full):
    """The planted fault: this rank's qkv cut contiguously from the full
    arrays (rank 0 gets all of q and half of k at mp = 2)."""
    import torch
    from paddle_tpu_torch.parallel import tp
    with torch.no_grad():
        for name in ("qkv_w", "qkv_b"):
            p = getattr(model, name)
            split, n, idx = p.mp_split
            p.copy_(tp.Split(split.dim).take(full[name].to(p.device, p.dtype),
                                             n, idx))


def _serve_ranks(models, axes, ids_t, fault=None):
    """Each rank's gathered logits (rank 0's) and loss under
    inference_mode, the host seconds of the run."""
    import torch
    from paddle_tpu_torch.models import gpt_loss
    from paddle_tpu_torch.parallel import LoopbackWorld

    def fn(rank, mesh):
        m = models[rank]
        m.apply_mesh(mesh)
        if fault is not None:
            fault(m)
        with torch.inference_mode():
            lg = m(ids_t)
            loss = float(gpt_loss(m, ids_t, ids_t))
        torch.cuda.synchronize()
        return (lg if rank == 0 else None), loss
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = LoopbackWorld(len(models)).run(fn, axes=axes)
    return out[0][0], [o[1] for o in out], time.perf_counter() - t0


def _train_ranks(models, axes, ids_t, make_opt, steps, plant=None, **kw):
    """``steps`` ShardedTrainStep steps on each rank: ([each rank's (losses,
    gathered parameters: rank 0's on the host, parameter bytes, host-hop
    bytes a step, the most pipeline microbatch graphs it held)], the host
    seconds a step).  ``plant(step)`` plants a fault in each rank's
    step."""
    import torch
    from paddle_tpu_torch.models import gpt_loss
    from paddle_tpu_torch.parallel import LoopbackWorld, ShardedTrainStep
    from paddle_tpu_torch.parallel import pipeline, tp

    def fn(rank, mesh):
        m = models[rank]
        step = ShardedTrainStep(m, gpt_loss, make_opt(), mesh=mesh, **kw)
        if plant is not None:
            plant(step)
        pbytes = sum(p.numel() * p.element_size() for p in m.parameters())
        tp.reset_host_bytes()
        pipeline.reset_live_graphs()
        losses = [float(step(ids_t, ids_t)) for _ in range(steps)]
        hop = tp.host_bytes() / steps
        full = step.gather_params()
        full = {n: t.detach().cpu() for n, t in full.items()} \
            if rank == 0 else {n: t.detach().clone() for n, t in full.items()}
        return losses, full, pbytes, hop, pipeline.peak_live_graphs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = LoopbackWorld(len(models)).run(fn, axes=axes)
    wall = (time.perf_counter() - t0) / steps
    return out, wall


@contextlib.contextmanager
def copy_to_without_sum():
    """The planted training fault at mp > 1: ``tp.copy_to``'s backward
    hands on this rank's gradient without the sum over mp (the replicated
    activations' and parameters' gradients lose the other ranks' part)."""
    from paddle_tpu_torch.parallel import tp
    sound = tp._Copy

    class NoSum(sound):
        @staticmethod
        def backward(ctx, g):
            return tp._back(g, ctx.device, ctx.hop), None, None
    tp._Copy = NoSum
    try:
        yield
    finally:
        tp._Copy = sound


def skip_sp_sum(step):
    """The planted training fault at sp > 1: the step leaves each rank's
    partial gradients unsummed over sp."""
    step._spgroup = None


def _ranks_equal(out):
    """Whether every rank's gathered parameters are rank 0's, bitwise."""
    import torch
    full0 = out[0][1]
    return all(torch.equal(full0[n], o[1][n].cpu()) for o in out[1:]
               for n in full0)


def one_rank_o2(base, ids_t):
    """The one-rank TrainStep (O2 bf16, AdamW(1e-4)) that phases 48-50
    hold their training to: TP_STEPS steps of a copy of ``base``, twice,
    the second run bitwise the first.  Returns (its losses, (its
    parameters, base's)), the parameters on the host."""
    import copy

    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import gpt_loss
    from paddle_tpu_torch.optimizer import AdamW
    init = {n: p.detach().cpu() for n, p in base.named_parameters()}
    runs = []
    for _ in range(2):
        one = copy.deepcopy(base)
        ts = TrainStep(one, gpt_loss, AdamW(learning_rate=1e-4),
                       amp_level="O2", amp_dtype="bfloat16")
        losses = [float(ts(ids_t, ids_t)) for _ in range(TP_STEPS)]
        runs.append((losses, {n: p.detach().cpu()
                              for n, p in one.named_parameters()}))
        del ts, one
        torch.cuda.empty_cache()
    (losses, want), (again, want2) = runs
    if again != losses or any(not torch.equal(want[n], want2[n])
                              for n in want):
        fail(f"tp-gpt: one-rank TrainStep is not bitwise itself: {losses}, "
             f"{again}")
    return losses, (want, init)


def _serve_pair(base, axes, ids_t, fa, dtype):
    """``base`` in ``dtype`` served (the logits and the loss) on one rank
    and on the ranks of ``axes``: ({the gathered logits' ||error|| /
    ||logits|| and max |error|, the max |logit|, the loss's error, the
    ranks' losses, host ms, #1-#3's launches on the ranks}, the one-rank
    model, its logits, its loss)."""
    import copy

    import torch
    from paddle_tpu_torch.models import gpt_loss
    one = copy.deepcopy(base).to(dtype)
    with torch.inference_mode():
        want_lg = one(ids_t)
        want_loss = float(gpt_loss(one, ids_t, ids_t))
    reset_fa(fa)
    lg, losses, sec = _serve_ranks(
        [copy.deepcopy(one) for _ in range(math.prod(axes.values()))], axes,
        ids_t)
    row = {"logits_err": _norm_err(lg, want_lg),
           "logits_abs_err": float((lg.float() - want_lg.float()).abs().max()),
           "max_logit": float(want_lg.float().abs().max()),
           "loss_err": max(abs(x - want_loss) for x in losses),
           "losses": losses, "logits_and_loss_ms": sec * 1e3,
           "launches": _tp_counts(fa)}
    return row, one, want_lg, want_loss


def tp_gpt_phase(base, cfg, ids_t, fa, want_losses, ref, power):
    """Phase 48: GPT-2 345M's width at PAR_LAYERS layers at mp = 2 (served in f32 and bf16, one f32 SGD
    step, 3 O2 steps against ``ref``, ``one_rank_o2``'s parameters) against
    mp = 1; the planted contiguous qkv cut and copy_to without its sum;
    dp x mp x sp = 2 x 2 x 2 at 2 layers against one-rank TrainStep;
    fleet with mp_degree = 2.  Returns the readings and #1-#3's
    launches."""
    import copy

    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPT, GPTConfig, gpt_loss
    from paddle_tpu_torch.optimizer import SGD, AdamW
    from paddle_tpu_torch.parallel import LoopbackWorld, ShardedTrainStep
    from paddle_tpu_torch.parallel import set_mesh
    L = cfg.num_layers
    row, launches = {}, {}
    whole_bytes = sum(p.numel() * p.element_size() for p in base.parameters())
    log(f"tp-gpt: GPT-2 345M's width at {L} layers, B={B}, S={S}, "
        f"remat=False, at mp = 2 on two "
        "LoopbackWorld ranks (threads) on the one card: every time is the "
        "simulation's, NCCL at two or more ranks is unmeasured")

    # serve in f32 (the order of the sums alone) and in bf16 (that order
    # rounded), the gathered logits and the loss against mp = 1; in bf16
    # the planted contiguous qkv cut
    for dtype, lim in ((torch.float32, TOL_F32),
                       (torch.bfloat16, TP_LOGITS_NORM)):
        sv, one, want_lg, want_loss = _serve_pair(base, {"mp": 2}, ids_t, fa,
                                                  dtype)
        _add(launches, sv["launches"])
        what = str(dtype).split(".")[1]
        # the logits and the loss: two forwards a rank
        if sv["launches"]["flash_attention_fwd"] != 2 * 2 * L:
            fail(f"tp-gpt serve {what}: #1 launched {sv['launches']}, not "
                 f"{L} a rank a forward")
        if sv["losses"][0] != sv["losses"][1]:
            fail(f"tp-gpt serve {what}: the ranks' losses differ "
                 f"{sv['losses']}")
        if dtype == torch.bfloat16:
            full = {n: p.detach() for n, p in one.named_parameters()}
            flg, f_losses, _ = _serve_ranks(
                [copy.deepcopy(one) for _ in range(2)], {"mp": 2}, ids_t,
                fault=lambda m: _contiguous_qkv(m, full))
            sv["fault_contiguous_qkv_logits_err"] = _norm_err(flg, want_lg)
            sv["fault_contiguous_qkv_loss_err"] = max(
                abs(x - want_loss) for x in f_losses)
            del flg, full
        log(f"tp-gpt serve at mp = 2 ({what}): gathered logits against "
            f"mp = 1 {sv['logits_err']:.4g} in norm (limit {lim}; max |err| "
            f"{sv['logits_abs_err']:.4g}, max |logit| {sv['max_logit']:.4g})"
            f", loss {sv['losses'][0]:.6f} ({sv['loss_err']:.3g}, limit "
            f"{TOL_LOSS_BF16}); {sv['logits_and_loss_ms']:.1f} ms for both "
            f"forwards (host clock, both ranks); planted contiguous qkv cut "
            f"{sv.get('fault_contiguous_qkv_logits_err', '-')} on the logits,"
            f" {sv.get('fault_contiguous_qkv_loss_err', '-')} on the loss "
            f"[{power}]")
        if sv["logits_err"] > lim or sv["loss_err"] > TOL_LOSS_BF16:
            fail(f"tp-gpt: the mp = 2 forward disagrees with mp = 1 ({what})")
        if dtype == torch.bfloat16 and not (
                sv["fault_contiguous_qkv_logits_err"] > lim
                or sv["fault_contiguous_qkv_loss_err"] > TOL_LOSS_BF16):
            fail("tp-gpt: the planted contiguous qkv cut was not caught")
        row[f"serve_{what}"] = sv
        del one, want_lg
        torch.cuda.empty_cache()

    # one f32 SGD step: the gradients, their sums in another order only
    init = _snap(base)
    one = copy.deepcopy(base)
    ts = TrainStep(one, gpt_loss, SGD(learning_rate=DP2_LR))
    want_l = float(ts(ids_t, ids_t))
    want_s = _snap(one)
    del ts, one
    torch.cuda.empty_cache()
    reset_fa(fa)
    out, sgd_s = _train_ranks([copy.deepcopy(base) for _ in range(2)],
                              {"mp": 2}, ids_t,
                              lambda: SGD(learning_rate=DP2_LR), 1)
    _add(launches, _tp_counts(fa))
    got = {n: t.cuda() for n, t in out[0][1].items()}
    f32 = {"loss_err": abs(out[0][0][0] - want_l),
           "move_err": _move_errs(got, want_s, init)[1],
           "move_l2_err": _move_l2(got, want_s, init),
           "ranks_equal": _ranks_equal(out), "step_ms": sgd_s * 1e3}
    log(f"tp-gpt one f32 SGD({DP2_LR}) step at mp = 2 against one-rank "
        f"TrainStep: loss {f32['loss_err']:.3g} (limit {TOL_DP2_LOSS}), "
        f"whole-move measure {f32['move_err']:.4g} (limit {TOL_DP2_MOVE}), "
        f"the move's L2 error {f32['move_l2_err']:.4g}; both ranks' "
        f"gathered parameters bitwise equal: {f32['ranks_equal']}; "
        f"{sgd_s * 1e3:.1f} ms (host clock, both ranks) [{power}]")
    if f32["loss_err"] > TOL_DP2_LOSS or f32["move_err"] > TOL_DP2_MOVE or \
            not f32["ranks_equal"]:
        fail("tp-gpt: the f32 mp = 2 step disagrees with one-rank TrainStep")
    row["train_f32_sgd"] = f32
    del out, got, want_s, init
    torch.cuda.empty_cache()

    # train: O2 bf16 AdamW(1e-4), against one-rank TrainStep; then the
    # planted copy_to without its sum over mp
    want_p, init_h = ref

    def adamw():
        return AdamW(learning_rate=1e-4)
    torch.cuda.reset_peak_memory_stats()
    reset_fa(fa)
    out, step_s = _train_ranks([copy.deepcopy(base) for _ in range(2)],
                               {"mp": 2}, ids_t, adamw, TP_STEPS,
                               amp_level="O2", amp_dtype="bfloat16")
    peak = torch.cuda.max_memory_allocated()
    train_launch = _tp_counts(fa)
    _add(launches, train_launch)
    with copy_to_without_sum():
        fout, _ = _train_ranks([copy.deepcopy(base) for _ in range(2)],
                               {"mp": 2}, ids_t, adamw, TP_STEPS,
                               amp_level="O2", amp_dtype="bfloat16")
    losses = out[0][0]
    loss_err = max(abs(a - b) for a, b in zip(losses, want_losses))
    l2 = _move_l2(out[0][1], want_p, init_h)
    _, whole_move, _ = _move_errs(out[0][1], want_p, init_h)
    same = _ranks_equal(out)
    fault = {"loss_err": max(abs(a - b) for a, b in zip(fout[0][0],
                                                       want_losses)),
             "move_l2_err": _move_l2(fout[0][1], want_p, init_h),
             "ranks_equal": _ranks_equal(fout)}
    rank_bytes = [o[2] for o in out]
    hop = [o[3] for o in out]
    want_n = (2 * L * TP_STEPS,) * 3
    if tuple(train_launch.values()) != want_n:
        fail(f"tp-gpt train: #1-#3 launched {train_launch}, not "
             f"{L} each a rank a step")
    log(f"tp-gpt train at mp = 2 (O2 bf16, AdamW(1e-4), {TP_STEPS} "
        f"steps): losses {losses} against one-rank TrainStep's "
        f"{want_losses[:TP_STEPS]} (max {loss_err:.3g}, limit "
        f"{TOL_LOSS_BF16}); gathered parameters: the move's error "
        f"{l2:.4g} of the move in L2 (limit {TP_MOVE_L2}), whole-move "
        f"measure {whole_move:.4g}; both ranks' gathered parameters "
        f"bitwise equal: {same}; the planted copy_to without its sum reads "
        f"{fault}; parameter bytes a rank {rank_bytes} "
        f"against {whole_bytes} whole; host hop {hop[0]:.0f} bytes a rank a "
        f"step; {step_s * 1e3:.1f} ms a step (host clock, both ranks: the "
        f"simulation's cost), max_memory_allocated {peak} bytes (both "
        f"ranks); #1-#3 {train_launch} [{power}]")
    if loss_err > TOL_LOSS_BF16 or l2 > TP_MOVE_L2 or not same:
        fail("tp-gpt: mp = 2 training disagrees with one-rank TrainStep")
    if not (fault["loss_err"] > TOL_LOSS_BF16
            or fault["move_l2_err"] > TP_MOVE_L2 or not fault["ranks_equal"]):
        fail("tp-gpt: the planted copy_to without its sum was not caught")
    row["train"] = {"losses": losses, "loss_err": loss_err,
                    "move_l2_err": l2, "whole_move_err": whole_move,
                    "param_bytes_per_rank": rank_bytes,
                    "param_bytes_whole": whole_bytes,
                    "host_hop_bytes_per_rank_step": hop,
                    "step_ms": step_s * 1e3, "peak_bytes": peak,
                    "launches": train_launch,
                    "fault_copy_to_without_sum": fault}
    del out, fout
    torch.cuda.empty_cache()

    # dp x mp x sp = 2 x 2 x 2 at 2 layers, f32, SGD: against one rank
    cfg2 = GPTConfig(hidden_size=cfg.hidden_size, num_heads=cfg.num_heads,
                     vocab_size=cfg.vocab_size, max_seq_len=cfg.max_seq_len,
                     num_layers=ZERO_DP2_LAYERS, remat=False)
    one = GPT(cfg2, device="cuda")
    init2 = _snap(one)
    ranks8 = [copy.deepcopy(one) for _ in range(8)]
    ts = TrainStep(one, gpt_loss, SGD(learning_rate=DP2_LR))
    want_l = [float(ts(ids_t, ids_t)) for _ in range(ZERO_DP2_STEPS)]
    want2 = _snap(one)
    del ts, one
    reset_fa(fa)

    def sgd():
        return SGD(learning_rate=DP2_LR)
    out, step3 = _train_ranks(ranks8, TP_3D_AXES, ids_t, sgd, ZERO_DP2_STEPS)
    d3_launch = _tp_counts(fa)
    _add(launches, d3_launch)
    got3 = {n: t.cuda() for n, t in out[0][1].items()}
    loss3 = max(abs(a - b) for a, b in zip(out[0][0], want_l))
    _, move3, _ = _move_errs(got3, want2, init2)
    # sp coordinate j launches j + 1 chunks a layer: 4 ranks at each j
    per = 4 * (1 + 2) * ZERO_DP2_LAYERS * ZERO_DP2_STEPS
    log(f"tp-gpt dp x mp x sp = 2 x 2 x 2 (8 threads, {ZERO_DP2_LAYERS} "
        f"layers, f32, SGD({DP2_LR})): losses {out[0][0]} against one-rank "
        f"TrainStep on the global batch {want_l}: loss {loss3:.3g} (limit "
        f"{TOL_DP2_LOSS}), whole-move measure {move3:.3g} (limit "
        f"{TOL_DP2_MOVE}); {step3 * 1e3:.1f} ms a step (host clock, 8 "
        f"ranks); #1-#3 {d3_launch} [{power}]")
    if loss3 > TOL_DP2_LOSS or move3 > TOL_DP2_MOVE:
        fail("tp-gpt: dp x mp x sp disagrees with one-rank TrainStep")
    if tuple(d3_launch.values()) != (per,) * 3:
        fail(f"tp-gpt dp x mp x sp: #1-#3 launched {d3_launch}, not {per}")
    row["dp_mp_sp"] = {"losses": out[0][0], "loss_err": loss3,
                       "move_err": move3, "step_ms": step3 * 1e3,
                       "launches": d3_launch}
    del out, got3, ranks8, init2, want2
    torch.cuda.empty_cache()

    # fleet with hybrid_configs={"mp_degree": 2} builds that step
    small = GPT(cfg2, device="cuda")
    fl_models = [copy.deepcopy(small) for _ in range(2)]
    del small

    def fleet_fn(rank, mesh):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"mp_degree": 2}
        fleet.init(is_collective=True, strategy=s)
        try:
            fleet.distributed_optimizer(SGD(learning_rate=DP2_LR))
            step = fleet.train_step(fl_models[rank], gpt_loss)
            ok = (isinstance(step, ShardedTrainStep)
                  and dict(step.mesh.shape) == {"mp": 2}
                  and fl_models[rank].wte.shape[0] == cfg.vocab_size // 2)
            return ok, float(step(ids_t, ids_t))
        finally:
            set_mesh(None)
    fl = LoopbackWorld(2).run(fleet_fn)
    log(f"tp-gpt fleet(hybrid_configs={{'mp_degree': 2}}): ShardedTrainStep "
        f"over {{'mp': 2}} with the rank's shards: {fl[0][0]}; one step's "
        f"loss {fl[0][1]:.6f} (rank 1 {fl[1][1]:.6f})")
    if not (fl[0][0] and fl[1][0]) or fl[0][1] != fl[1][1]:
        fail("tp-gpt: fleet with mp_degree 2 did not build its step")
    row["fleet_mp2_loss"] = fl[0][1]
    del fl_models
    torch.cuda.empty_cache()
    return row, launches


RING_FAULTS = ("all_causal", "merge_without_lse", "delta_from_chunk")


@contextlib.contextmanager
def ring_fault(name):
    """Plant one of the ring's faults (``RING_FAULTS``) in
    ``parallel/ring_attention.py`` while the block runs: "all_causal"
    runs every chunk causal, "merge_without_lse" averages the chunks'
    outputs, "delta_from_chunk" takes the backward's delta from the
    diagonal chunk's output instead of the merged one."""
    import importlib
    # (the package binds the name ring_attention to the function)
    ra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")
    fa = ra._fa
    saved = []

    def patch(mod, attr, new):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)
    if name == "all_causal":
        fwd, bwd = ra._chunk_fwd, ra._chunk_bwd
        patch(ra, "_chunk_fwd",
              lambda qt, kt, vt, scale, causal, flash:
              fwd(qt, kt, vt, scale, True, flash))
        patch(ra, "_chunk_bwd", lambda *a: bwd(*a[:8], True, a[9]))
    elif name == "merge_without_lse":
        merge = ra._merge

        def averaged(outs, lses, dtype):
            out, lse = merge(outs, lses, dtype)
            return (sum(o.float() for o in outs) / len(outs)).to(dtype), lse
        patch(ra, "_merge", averaged)
    elif name == "delta_from_chunk":
        merge, delta, diag = ra._merge, fa._delta, {}

        def keep_diagonal(outs, lses, dtype):
            out, lse = merge(outs, lses, dtype)
            diag[out.data_ptr()] = outs[0]       # step 0: the diagonal
            return out, lse
        patch(ra, "_merge", keep_diagonal)
        patch(fa, "_delta",
              lambda dot, ot: delta(dot, diag.get(ot.data_ptr(), ot)))
    else:
        raise ValueError(f"unknown ring fault {name!r}")
    try:
        yield
    finally:
        for mod, attr, old in reversed(saved):
            setattr(mod, attr, old)


def _ring_case(g, sp, fa, fault=None, timed=True):
    """The ring at sp ranks on bench_longseq_flash's layer, against #1-#3
    on the whole sequence: (out abs err, out rel err, grad rel errs, the
    ring's #1-#3 launches, forward ms, forward + backward ms)."""
    import torch
    from paddle_tpu_torch.parallel import LoopbackWorld
    from paddle_tpu_torch.parallel.ring_attention import _ring
    b, h, s, d = LONG_B, LONG_HEADS, LONG_S, LONG_WIDTH // LONG_HEADS
    bf16 = torch.bfloat16
    q, k, v, do = (rand(g, (b, s, h, d), bf16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt, dot = (fa._fold(t) for t in (q, k, v, do))
    ot, lse = fa._launch(qt, kt, vt, scale, True)
    delta = fa._delta(dot, ot)
    dq = fa._launch_dq(qt, kt, vt, dot, lse, delta, scale, True)
    dk, dv = fa._launch_dkv(qt, kt, vt, dot, lse, delta, scale, True)
    want = [fa._unfold(t, b, h) for t in (ot, dq, dk, dv)]
    w = s // sp

    def fn(rank, mesh, backward=True):
        sl = slice(rank * w, (rank + 1) * w)
        xs = [t[:, sl].detach().clone().requires_grad_(backward)
              for t in (q, k, v)]
        group = mesh.axis_group("sp")
        out = _ring(*xs, True, scale, group)
        if backward:
            out.backward(do[:, sl])
        torch.cuda.synchronize()
        return [out.detach()] + ([x.grad for x in xs] if backward else [])
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    with ring_fault(fault) if fault else contextlib.nullcontext():
        got = LoopbackWorld(sp).run(fn, axes={"sp": sp})
    counts = _tp_counts(fa)
    parts = [torch.cat([r[i] for r in got], 1) for i in range(4)]
    out_abs = float((parts[0].float() - want[0].float()).abs().max())
    out_rel = grad_err(parts[0], want[0])[0]
    grads = [grad_err(a, b_)[0] for a, b_ in zip(parts[1:], want[1:])]
    times = [None, None]
    for backward in (False, True) if timed else ():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RING_REPS):
            LoopbackWorld(sp).run(lambda r, m: fn(r, m, backward),
                                  axes={"sp": sp})
        times[backward] = (time.perf_counter() - t0) / RING_REPS * 1e3
    return out_abs, out_rel, grads, counts, times[0], times[1]


def sp_ring_phase(base, cfg, ids_t, fa, want_losses, ref, power):
    """Phase 49: ring attention at S = 8192 (sp = 2, 4) against #1-#3 on
    the whole sequence, with its planted faults; GPT-2 345M's width at
    PAR_LAYERS layers at sp = 2
    served (f32, bf16) against sp = 1 and trained against ``ref``
    (``one_rank_o2``'s parameters), with the planted skip of the sum over
    sp.  Returns the readings and #1-#3's launches."""
    import copy

    import torch
    from paddle_tpu_torch.models import gpt_loss
    from paddle_tpu_torch.optimizer import AdamW
    L = cfg.num_layers
    row, launches = {}, {}
    g = torch.Generator(device="cuda").manual_seed(49)
    for sp in RING_SPS:
        out_abs, out_rel, grads, counts, fwd_ms, fb_ms = _ring_case(g, sp, fa)
        _add(launches, counts)
        n_chunks = sp * (sp + 1) // 2
        log(f"sp-ring sp = {sp} (B*H = {LONG_B * LONG_HEADS}, S = {LONG_S}, "
            f"D = {LONG_WIDTH // LONG_HEADS}, causal, bf16; {sp} LoopbackWorld threads): out "
            f"max |err| {out_abs:.4g} (limit {TOL_BF16}), relative "
            f"{out_rel:.4g} (limit {TOL_FWD_BF16}); dq, dk, dv "
            f"{[round(x, 5) for x in grads]} (limit {TOL_GRAD_BF16}); "
            f"#1-#3 {counts} (want {n_chunks} each); forward "
            f"{fwd_ms:.3f} ms, forward + backward {fb_ms:.3f} ms (host "
            f"clock, all ranks, the simulation's cost) beside longseq's "
            f"whole-sequence 0.2260 / 0.3411 / 0.5299 ms [{power}]")
        if out_abs > TOL_BF16 or out_rel > TOL_FWD_BF16 or \
                max(grads) > TOL_GRAD_BF16:
            fail(f"sp-ring sp = {sp}: the ring disagrees with the whole "
                 "sequence")
        if tuple(counts.values()) != (n_chunks,) * 3:
            fail(f"sp-ring sp = {sp}: #1-#3 launched {counts}, not "
                 f"{n_chunks} each")
        faults = {}
        for fault in RING_FAULTS:
            _, f_rel, f_grads, _, _, _ = _ring_case(g, sp, fa, fault,
                                                    timed=False)
            faults[fault] = {"out_rel": f_rel, "grads": f_grads}
            if not (f_rel > TOL_FWD_BF16 or max(f_grads) > TOL_GRAD_BF16):
                fail(f"sp-ring sp = {sp}: the planted {fault} read out "
                     f"{f_rel:.3g}, grads {f_grads}: not caught")
        log(f"sp-ring sp = {sp}: planted faults read (out relative, dq / "
            f"dk / dv) {faults}: caught")
        row[f"ring_sp{sp}"] = {"out_abs_err": out_abs, "out_rel_err": out_rel,
                               "grad_errs": grads, "launches": counts,
                               "fwd_ms": fwd_ms, "fwd_bwd_ms": fb_ms,
                               "faults": faults}
    torch.cuda.empty_cache()

    # GPT-2 345M's width at sp = 2: served in f32 and bf16 against sp = 1, trained
    # against one-rank TrainStep (``ref``); then the planted skip
    # of the gradients' sum over sp
    for dtype, lim in ((torch.float32, TOL_F32),
                       (torch.bfloat16, TP_LOGITS_NORM)):
        sv, one, want_lg, _ = _serve_pair(base, {"sp": 2}, ids_t, fa, dtype)
        _add(launches, sv["launches"])
        what = str(dtype).split(".")[1]
        log(f"sp-ring GPT-2 345M's width ({L} layers) serve at sp = 2 (512 positions a rank, "
            f"{what}): gathered logits {sv['logits_err']:.4g} in norm (limit "
            f"{lim}; max |err| {sv['logits_abs_err']:.4g}), loss "
            f"{sv['loss_err']:.3g} (limit {TOL_LOSS_BF16}); "
            f"{sv['logits_and_loss_ms']:.1f} ms for the logits and the loss "
            f"(host clock); #1 {sv['launches']['flash_attention_fwd']} "
            f"[{power}]")
        if sv["logits_err"] > lim or sv["loss_err"] > TOL_LOSS_BF16:
            fail(f"sp-ring: the sp = 2 forward disagrees with sp = 1 ({what})")
        # rank j attends j + 1 chunks a layer, two forwards a rank
        if sv["launches"]["flash_attention_fwd"] != 2 * 3 * L:
            fail(f"sp-ring serve {what}: #1 launched {sv['launches']}, not "
                 f"{2 * 3 * L}")
        row[f"gpt_sp2_serve_{what}"] = sv
        del one, want_lg
        torch.cuda.empty_cache()
    want_p, init_h = ref

    def adamw():
        return AdamW(learning_rate=1e-4)
    reset_fa(fa)
    out, step_s = _train_ranks([copy.deepcopy(base) for _ in range(2)],
                               {"sp": 2}, ids_t, adamw, TP_STEPS,
                               amp_level="O2", amp_dtype="bfloat16")
    train_launch = _tp_counts(fa)
    _add(launches, train_launch)
    fout, _ = _train_ranks([copy.deepcopy(base) for _ in range(2)],
                           {"sp": 2}, ids_t, adamw, TP_STEPS,
                           plant=skip_sp_sum, amp_level="O2",
                           amp_dtype="bfloat16")
    losses = out[0][0]
    loss_err = max(abs(a - b) for a, b in zip(losses, want_losses))
    l2 = _move_l2(out[0][1], want_p, init_h)
    _, whole_move, _ = _move_errs(out[0][1], want_p, init_h)
    same = _ranks_equal(out)
    fault = {"loss_err": max(abs(a - b) for a, b in zip(fout[0][0],
                                                       want_losses)),
             "move_l2_err": _move_l2(fout[0][1], want_p, init_h),
             "ranks_equal": _ranks_equal(fout)}
    log(f"sp-ring GPT-2 345M's width ({L} layers) train at sp = 2 (O2 bf16, AdamW(1e-4)): losses "
        f"{losses} against one-rank TrainStep's {want_losses[:TP_STEPS]} (max "
        f"{loss_err:.3g}, limit {TOL_LOSS_BF16}); gathered parameters: the "
        f"move's error {l2:.4g} of the move in L2 (limit {TP_MOVE_L2}), "
        f"whole-move measure {whole_move:.4g}; both ranks' gathered "
        f"parameters bitwise equal: {same}; the planted skip of the sum "
        f"over sp reads {fault}; host hop {out[0][3]:.0f} bytes a rank a "
        f"step; {step_s * 1e3:.1f} ms a step (host clock, both ranks); "
        f"#1-#3 {train_launch} [{power}]")
    if loss_err > TOL_LOSS_BF16 or out[0][0] != out[1][0] or \
            l2 > TP_MOVE_L2 or not same:
        fail("sp-ring: sp = 2 training disagrees with one-rank TrainStep")
    if not (fault["loss_err"] > TOL_LOSS_BF16
            or fault["move_l2_err"] > TP_MOVE_L2 or not fault["ranks_equal"]):
        fail("sp-ring: the planted skip of the sum over sp was not caught")
    if tuple(train_launch.values()) != (3 * L * TP_STEPS,) * 3:
        fail(f"sp-ring train: #1-#3 launched {train_launch}, not "
             f"{3 * L * TP_STEPS} each")
    row["gpt_sp2_train"] = {"losses": losses, "loss_err": loss_err,
                            "move_l2_err": l2, "whole_move_err": whole_move,
                            "ranks_equal": same,
                            "host_hop_bytes_per_rank_step": out[0][3],
                            "step_ms": step_s * 1e3,
                            "launches": train_launch,
                            "fault_skip_sp_sum": fault}
    del out, fout
    torch.cuda.empty_cache()
    return row, launches


# -- the pipeline (phase 50) --------------------------------------------------
# Ranks are LoopbackWorld threads on the one card, each stage a thread:
# every time below is the simulation's (the stages' work runs one after
# another on one card, so no bubble can be read), and NCCL's p2p at two or
# more ranks is unmeasured.  pp-gpt (50) holds GPT-2 345M's width at
# PAR_LAYERS layers at pp = 2 (4 layers a stage, PP_MICRO microbatches of
# 2 rows) to one rank.  Served:
# the gathered logits by ||error|| / ||logits|| at TOL_F32 in f32 and at
# TP_LOGITS_NORM in bf16 (phase 48's limit for the same logits), the loss
# at TOL_LOSS_BF16.  Trained: one f32 SGD(DP2_LR) step in each schedule,
# the loss and the whole move (max |error| over the largest leaf's largest
# move) at PP_F32; PP_STEPS O2 AdamW(1e-4) steps in each schedule against
# ``one_rank_o2``'s parameters, the losses at TOL_LOSS_BF16 and the move's
# L2 error at PP_MOVE_L2.  The planted faults each limit must catch: the
# boundary's input gradient not sent back (stage 0's layers and the
# embedding do not move; bf16, F-then-B), the last stage's labels one
# microbatch off (bf16, 1F1B), wte's gradient summed over the stages
# instead of counted once (f32 SGD: Adam's move is blind to a gradient's
# scale).  PP_MOVE_L2 is the geometric mean of the sound and the planted
# bf16 readings, one significant digit, rounded down, as phase 48's.  On
# an H100 (700 W): the bf16 logits read 0 (the same bits as pp = 1), f32
# 2.6e-6; the f32 step's whole move 1.7e-5 / 3.4e-5 (F-then-B / 1F1B),
# wte summed over the stages 0.063; the O2 move 0.0108 / 0.0335 in L2
# (pp = 4 0.0350) against the faults' 0.783 (gradient not sent back) and
# 1.076 (labels off): sqrt(0.0350 * 0.783) = 0.166 -> 0.1.
PP_STEPS = 3
PP_MICRO = 4
PP_F32 = 1e-4
PP_MOVE_L2 = 0.1
# pp = 4 (6 layers a stage, 8 microbatches of 1 row), 1F1B, bf16
PP4_MICRO = 8
# at ZERO_DP2_LAYERS layers in f32 with SGD(DP2_LR), against one-rank
# TrainStep on the global batch by TOL_DP2_LOSS / TOL_DP2_MOVE
PP_3D_AXES = {"dp": 2, "pp": 2, "mp": 2}
PP_SP_AXES = {"pp": 2, "sp": 2}


@contextlib.contextmanager
def grad_not_sent_back():
    """The planted fault: every stage hands the previous one zeros for its
    input's gradient (stage 0's layers and the embedding before the
    pipeline get none)."""
    import torch
    from paddle_tpu_torch.parallel import pipeline
    sound = pipeline._send_back

    def zeros(group, g, dst, pending):
        sound(group, torch.zeros_like(g), dst, pending)
    pipeline._send_back = zeros
    try:
        yield
    finally:
        pipeline._send_back = sound


@contextlib.contextmanager
def labels_one_microbatch_off():
    """The planted fault: the 1F1B program's last stage scores microbatch
    m against microbatch m + 1's labels."""
    from paddle_tpu_torch.parallel import pipeline
    sound = pipeline.make_pipeline_train_1f1b

    def shifted(stage_fn, head_loss_fn, n_micro, *args, **kwargs):
        fn = sound(stage_fn, head_loss_fn, n_micro, *args, **kwargs)

        def loss_fn(stacked, head, x, labels):
            return fn(stacked, head, x,
                      labels.roll(-(labels.shape[0] // n_micro), 0))
        return loss_fn
    pipeline.make_pipeline_train_1f1b = shifted
    try:
        yield
    finally:
        pipeline.make_pipeline_train_1f1b = sound


@contextlib.contextmanager
def wte_grad_on_every_stage():
    """The planted fault: the step sums the tied embedding's gradient over
    the stages, each of which already holds the whole of it."""
    from paddle_tpu_torch.parallel import sharded
    from paddle_tpu_torch.parallel.mesh import get_mesh, sum_over
    sound = sharded.loss_and_grads

    def counted(loss_from, params, inputs):
        loss, grads = sound(loss_from, params, inputs)
        grads["wte"] = sum_over(get_mesh().axis_group("pp"), grads["wte"])
        return loss, grads
    sharded.loss_and_grads = counted
    try:
        yield
    finally:
        sharded.loss_and_grads = sound


def _pp_copies(model, n, mode, micro):
    """n deep copies of ``model`` set to ``schedule_mode`` ``mode`` and
    ``micro`` microbatches (each rank's model)."""
    import copy
    out = []
    for _ in range(n):
        m = copy.deepcopy(model)
        m.config.schedule_mode = mode
        m.config.n_microbatches = micro
        out.append(m)
    return out


def _pp_train(base, axes, mode, micro, ids_t, make_opt, steps, fa, **kw):
    """``steps`` ShardedTrainStep steps of copies of ``base`` on ``axes``
    in ``mode``: (_train_ranks' ranks, host ms a step, #1-#3 launches,
    max_memory_allocated of the run)."""
    import torch
    n = math.prod(axes.values())
    models = _pp_copies(base, n, mode, micro)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_fa(fa)
    out, step_s = _train_ranks(models, axes, ids_t, make_opt, steps, **kw)
    launch = _tp_counts(fa)
    peak = torch.cuda.max_memory_allocated()
    del models
    torch.cuda.empty_cache()
    return out, step_s * 1e3, launch, peak


def pp_gpt_phase(base, cfg, ids_t, fa, want_losses, ref, power):
    """Phase 50: GPT-2 345M's width at PAR_LAYERS layers at pp = 2 served (f32, bf16) against pp = 1;
    one f32 SGD step in each schedule and 3 O2 AdamW steps in each
    against ``ref`` (``one_rank_o2``'s parameters), with the planted
    faults; pp = 4 in 1F1B; dp x pp x mp = 2 x 2 x 2 and pp x sp = 2 x 2
    at 2 layers against one-rank TrainStep.  Returns the readings and
    #1-#3's launches."""
    import copy

    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPT, GPTConfig, gpt_loss
    from paddle_tpu_torch.optimizer import SGD, AdamW
    L = cfg.num_layers
    row, launches = {}, {}
    log(f"pp-gpt: GPT-2 345M's width at {L} layers, B={B}, S={S}, "
        f"remat=False, at pp = 2 on two "
        f"LoopbackWorld ranks (threads) on the one card, {PP_MICRO} "
        "microbatches: every time is the simulation's (the stages run one "
        "after another on one card), NCCL at two or more ranks is "
        "unmeasured")
    # each forward of a rank: its L / 2 layers on each microbatch
    per_fwd = L // 2 * PP_MICRO

    # serve in f32 and bf16: the gathered logits and the loss against
    # pp = 1, in each schedule (mode 1's loss is the 1F1B program's
    # evaluation: the pipeline, then the head a microbatch)
    for dtype, lim in ((torch.float32, TOL_F32),
                       (torch.bfloat16, TP_LOGITS_NORM)):
        what = str(dtype).split(".")[1]
        for mode in (0, 1):
            m0 = copy.deepcopy(base)
            m0.config.schedule_mode, m0.config.n_microbatches = mode, \
                PP_MICRO
            sv, one, _, _ = _serve_pair(m0, {"pp": 2}, ids_t, fa, dtype)
            del m0, one
            _add(launches, sv["launches"])
            if sv["launches"]["flash_attention_fwd"] != 2 * 2 * per_fwd:
                fail(f"pp-gpt serve {what} mode {mode}: #1 launched "
                     f"{sv['launches']}, not {per_fwd} a rank a forward")
            if sv["losses"][0] != sv["losses"][1]:
                fail(f"pp-gpt serve {what}: the stages' losses differ "
                     f"{sv['losses']}")
            log(f"pp-gpt serve at pp = 2 ({what}, schedule_mode {mode}): "
                f"gathered logits against pp = 1 {sv['logits_err']:.4g} in "
                f"norm (limit {lim}; max |err| {sv['logits_abs_err']:.4g}, "
                f"max |logit| {sv['max_logit']:.4g}), loss "
                f"{sv['losses'][0]:.6f} ({sv['loss_err']:.3g}, limit "
                f"{TOL_LOSS_BF16}); {sv['logits_and_loss_ms']:.1f} ms for "
                f"both forwards (host clock, both ranks); #1 "
                f"{sv['launches']['flash_attention_fwd']} [{power}]")
            if sv["logits_err"] > lim or sv["loss_err"] > TOL_LOSS_BF16:
                fail(f"pp-gpt: the pp = 2 forward disagrees with pp = 1 "
                     f"({what}, mode {mode})")
            row[f"serve_{what}_mode{mode}"] = sv
            torch.cuda.empty_cache()

    # one f32 SGD step in each schedule: the gradients in another order
    # only; then the planted wte gradient summed over the stages
    init = _snap(base)
    one = copy.deepcopy(base)
    ts = TrainStep(one, gpt_loss, SGD(learning_rate=DP2_LR))
    want_l = float(ts(ids_t, ids_t))
    want_s = _snap(one)
    del ts, one
    torch.cuda.empty_cache()

    def sgd():
        return SGD(learning_rate=DP2_LR)

    def f32_reading(mode, fault=None):
        with fault() if fault else contextlib.nullcontext():
            out, ms, launch, _ = _pp_train(base, {"pp": 2}, mode, PP_MICRO,
                                           ids_t, sgd, 1, fa)
        got = {n: t.cuda() for n, t in out[0][1].items()}
        r = {"loss_err": abs(out[0][0][0] - want_l),
             "move_err": _move_errs(got, want_s, init)[1],
             "move_l2_err": _move_l2(got, want_s, init),
             "ranks_equal": _ranks_equal(out), "step_ms": ms,
             "launches": launch}
        del out, got
        torch.cuda.empty_cache()
        return r
    for mode in (0, 1):
        f32 = f32_reading(mode)
        _add(launches, f32["launches"])
        log(f"pp-gpt one f32 SGD({DP2_LR}) step at pp = 2, schedule_mode "
            f"{mode}, against one-rank TrainStep: loss {f32['loss_err']:.3g},"
            f" whole-move measure {f32['move_err']:.4g} (limits {PP_F32}), "
            f"the move's L2 error {f32['move_l2_err']:.4g}; both stages' "
            f"gathered parameters bitwise equal: {f32['ranks_equal']}; "
            f"{f32['step_ms']:.1f} ms (host clock, both ranks); #1-#3 "
            f"{f32['launches']} [{power}]")
        if f32["loss_err"] > PP_F32 or f32["move_err"] > PP_F32 or \
                not f32["ranks_equal"]:
            fail(f"pp-gpt: the f32 pp = 2 step (mode {mode}) disagrees with "
                 "one-rank TrainStep")
        row[f"train_f32_sgd_mode{mode}"] = f32
    fault = f32_reading(0, wte_grad_on_every_stage)
    _add(launches, fault["launches"])
    log(f"pp-gpt planted: wte's gradient summed over the stages (f32 SGD, "
        f"F-then-B): loss {fault['loss_err']:.3g}, whole move "
        f"{fault['move_err']:.4g}, L2 {fault['move_l2_err']:.4g}")
    if not (fault["loss_err"] > PP_F32 or fault["move_err"] > PP_F32):
        fail("pp-gpt: the planted wte gradient on every stage was not "
             "caught")
    row["fault_wte_every_stage"] = fault
    del init, want_s

    # O2 bf16 AdamW(1e-4), PP_STEPS steps in each schedule, against
    # one-rank TrainStep; the planted gradient not sent back (F-then-B)
    # and labels one microbatch off (1F1B)
    want_p, init_h = ref

    def adamw():
        return AdamW(learning_rate=1e-4)

    def bf16_reading(axes, mode, micro, fault=None):
        with fault() if fault else contextlib.nullcontext():
            out, ms, launch, peak = _pp_train(
                base, axes, mode, micro, ids_t, adamw, PP_STEPS, fa,
                amp_level="O2", amp_dtype="bfloat16")
        r = {"losses": out[0][0],
             "loss_err": max(abs(a - b) for a, b in zip(out[0][0],
                                                        want_losses)),
             "move_l2_err": _move_l2(out[0][1], want_p, init_h),
             "whole_move_err": _move_errs(out[0][1], want_p, init_h)[1],
             "ranks_equal": _ranks_equal(out),
             "losses_equal": all(o[0] == out[0][0] for o in out),
             "param_bytes_per_rank": [o[2] for o in out],
             "host_hop_bytes_per_rank_step": [o[3] for o in out],
             "peak_live_graphs": [o[4] for o in out], "step_ms": ms,
             "peak_bytes": peak, "launches": launch}
        del out
        torch.cuda.empty_cache()
        return r
    for mode in (0, 1):
        tr = bf16_reading({"pp": 2}, mode, PP_MICRO)
        _add(launches, tr["launches"])
        per_rank = {k: v // 2 // PP_STEPS for k, v in tr["launches"].items()}
        live = [PP_MICRO] * 2 if mode == 0 else [2, 1]
        log(f"pp-gpt train at pp = 2, schedule_mode {mode} (O2 bf16, "
            f"AdamW(1e-4), {PP_STEPS} steps): losses {tr['losses']} against "
            f"one-rank TrainStep's {want_losses[:PP_STEPS]} (max "
            f"{tr['loss_err']:.3g}, limit {TOL_LOSS_BF16}); the move's error "
            f"{tr['move_l2_err']:.4g} of the move in L2 (limit {PP_MOVE_L2})"
            f", whole-move measure {tr['whole_move_err']:.4g}; both stages' "
            f"gathered parameters bitwise equal: {tr['ranks_equal']}; live "
            f"microbatch graphs at most {tr['peak_live_graphs']} by stage "
            f"(want {live}); parameter bytes a rank "
            f"{tr['param_bytes_per_rank']}; host hop "
            f"{tr['host_hop_bytes_per_rank_step']} bytes a rank a step; "
            f"{tr['step_ms']:.1f} ms a step (host clock, both ranks: the "
            f"simulation's cost), max_memory_allocated {tr['peak_bytes']} "
            f"bytes (both ranks); #1-#3 a rank a step {per_rank} [{power}]")
        if tr["loss_err"] > TOL_LOSS_BF16 or tr["move_l2_err"] > PP_MOVE_L2 \
                or not tr["ranks_equal"] or not tr["losses_equal"]:
            fail(f"pp-gpt: pp = 2 training (mode {mode}) disagrees with "
                 "one-rank TrainStep")
        if tuple(tr["launches"].values()) != (2 * PP_STEPS * per_fwd,) * 3:
            fail(f"pp-gpt train mode {mode}: #1-#3 launched "
                 f"{tr['launches']}, not {per_fwd} each a rank a step")
        if tr["peak_live_graphs"] != live:
            fail(f"pp-gpt train mode {mode}: live microbatch graphs "
                 f"{tr['peak_live_graphs']}, not {live}")
        row[f"train_mode{mode}"] = tr
    for name, mode, plant in (("grad_not_sent_back", 0, grad_not_sent_back),
                              ("labels_one_microbatch_off", 1,
                               labels_one_microbatch_off)):
        fr = bf16_reading({"pp": 2}, mode, PP_MICRO, plant)
        _add(launches, fr["launches"])
        log(f"pp-gpt planted: {name} (O2 bf16, schedule_mode {mode}): "
            f"losses {fr['losses']} ({fr['loss_err']:.3g}), the move's L2 "
            f"error {fr['move_l2_err']:.4g}, whole move "
            f"{fr['whole_move_err']:.4g}")
        if not (fr["loss_err"] > TOL_LOSS_BF16
                or fr["move_l2_err"] > PP_MOVE_L2):
            fail(f"pp-gpt: the planted {name} was not caught")
        row[f"fault_{name}"] = {k: fr[k] for k in (
            "losses", "loss_err", "move_l2_err", "whole_move_err")}

    # pp = 4: 6 layers a stage, 8 microbatches of one row, 1F1B
    tr = bf16_reading({"pp": 4}, 1, PP4_MICRO)
    _add(launches, tr["launches"])
    per4 = L // 4 * PP4_MICRO
    log(f"pp-gpt train at pp = 4 (1F1B, {PP4_MICRO} microbatches, O2 bf16, "
        f"AdamW(1e-4)): losses {tr['losses']} (max {tr['loss_err']:.3g}); "
        f"the move's L2 error {tr['move_l2_err']:.4g} (limit {PP_MOVE_L2}); "
        f"stages bitwise equal: {tr['ranks_equal']}; live graphs "
        f"{tr['peak_live_graphs']}; {tr['step_ms']:.1f} ms a step (host "
        f"clock, 4 ranks), max_memory_allocated {tr['peak_bytes']} bytes; "
        f"#1-#3 {tr['launches']} [{power}]")
    if tr["loss_err"] > TOL_LOSS_BF16 or tr["move_l2_err"] > PP_MOVE_L2 \
            or not tr["ranks_equal"] or not tr["losses_equal"]:
        fail("pp-gpt: pp = 4 training disagrees with one-rank TrainStep")
    if tuple(tr["launches"].values()) != (4 * PP_STEPS * per4,) * 3 or \
            tr["peak_live_graphs"] != [4, 3, 2, 1]:
        fail(f"pp-gpt pp = 4: #1-#3 {tr['launches']} (want "
             f"{4 * PP_STEPS * per4} each), live {tr['peak_live_graphs']}")
    row["train_pp4"] = tr

    # dp x pp x mp = 2 x 2 x 2 (1F1B) and pp x sp = 2 x 2 (both schedules)
    # at 2 layers, f32, SGD: against one-rank TrainStep
    cfg2 = GPTConfig(hidden_size=cfg.hidden_size, num_heads=cfg.num_heads,
                     vocab_size=cfg.vocab_size, max_seq_len=cfg.max_seq_len,
                     num_layers=ZERO_DP2_LAYERS, remat=False)
    small = GPT(cfg2, device="cuda")
    init2 = _snap(small)
    one = copy.deepcopy(small)
    ts = TrainStep(one, gpt_loss, SGD(learning_rate=DP2_LR))
    want_l2 = [float(ts(ids_t, ids_t)) for _ in range(ZERO_DP2_STEPS)]
    want2 = _snap(one)
    del ts, one
    # M = max(1, pp) = 2 microbatches: at dp x pp x mp 1 layer x 2 a rank
    # a step; at pp x sp the ring's 1 + 2 chunks a layer over the two sp
    # coordinates, on each of 2 stages and 2 microbatches
    for axes, mode, per in ((PP_3D_AXES, 1, 8 * 2),
                            (PP_SP_AXES, 0, 2 * 3 * 2),
                            (PP_SP_AXES, 1, 2 * 3 * 2)):
        out, ms, launch, _ = _pp_train(small, axes, mode, 1, ids_t, sgd,
                                       ZERO_DP2_STEPS, fa)
        _add(launches, launch)
        got = {n: t.cuda() for n, t in out[0][1].items()}
        loss_e = max(abs(a - b) for a, b in zip(out[0][0], want_l2))
        move_e = _move_errs(got, want2, init2)[1]
        name = "_x_".join(f"{a}{s}" for a, s in axes.items())
        log(f"pp-gpt {name} (schedule_mode {mode}, {math.prod(axes.values())}"
            f" threads, {ZERO_DP2_LAYERS} layers, f32, SGD({DP2_LR})): losses"
            f" {out[0][0]} against one-rank TrainStep {want_l2}: loss "
            f"{loss_e:.3g} (limit {TOL_DP2_LOSS}), whole move {move_e:.3g} "
            f"(limit {TOL_DP2_MOVE}); {ms:.1f} ms a step (host clock); "
            f"#1-#3 {launch} [{power}]")
        if loss_e > TOL_DP2_LOSS or move_e > TOL_DP2_MOVE:
            fail(f"pp-gpt: {name} disagrees with one-rank TrainStep")
        if tuple(launch.values()) != (per * ZERO_DP2_STEPS,) * 3:
            fail(f"pp-gpt {name}: #1-#3 launched {launch}, not "
                 f"{per * ZERO_DP2_STEPS} each")
        row[f"{name}_mode{mode}"] = {"losses": out[0][0], "loss_err": loss_e,
                                     "move_err": move_e, "step_ms": ms,
                                     "launches": launch}
        del out, got
    del small, init2, want2
    torch.cuda.empty_cache()
    return row, launches


# -- BERT's mp path and the parameter server (phases 51-54) ------------------
# bert-mp (51) holds BERT-base at mp = 2 to mp = 1 by tp-gpt's rules:
# served in bf16, the gathered MLM logits by ||error|| / ||logits|| at
# BERT_MP_LOGITS_NORM and the loss at TOL_LOSS_BF16, beside the qkv shard
# cut contiguously; BERT_MP_STEPS O2 AdamW(1e-4) steps (remat=False: the
# replay of the collectives raises on loopback ranks on the card) against
# one-rank TrainStep, the losses at TOL_LOSS_BF16 and the move's L2 error
# at BERT_MP_MOVE_L2, beside copy_to without its sum.  The parameter server's
# phases (52-54) run bench.py's Wide&Deep legs at their sizes, timed as
# bench.py times them (PS_WARM warm-up steps, then PS_ITERS, the host's
# clock to a read of the last loss), and hold the card to the port's CPU
# path at bench.py's CPU size in f32 (TOL_PS_F32, relative to the largest
# value), each beside a planted fault.
BERT_MP_STEPS = 3
# bert-mp's limits by tp-gpt's rule (the geometric mean of the sound
# reading and the planted fault's, one digit, rounded down), from the
# first H100 (700 W) readings: the logits 0.0080 against the contiguous
# qkv cut's 0.134 (BERT's attention output is a small part of its post-LN
# residual, so the cut reads under GPT's 0.832); the move 0.0255 against
# copy_to without its sum's 0.624
BERT_MP_LOGITS_NORM = 0.03
BERT_MP_MOVE_L2 = 0.1
PS_WARM, PS_ITERS = 2, 20
TOL_PS_F32 = 1e-4
# the host-table leg's shapes (bench.py:440-485): 100M ids x (64 + 1)
PS_B, PS_V, PS_E = 16384, 100_000_000, 64
PS_FIELDS, PS_DENSE = 26, 13
# a pushed gradient against the per-slot gradients summed over each id,
# both bf16 (one rounding of a sum in another order): max |error| over
# max |want|
TOL_PS_PUSH = 2e-2


def _bert_serve_ranks(models, args, fault=None):
    """Each rank's gathered MLM logits (rank 0's) and loss under
    inference_mode at mp = 2, and the host seconds of the run."""
    import torch
    from paddle_tpu_torch.models import bert_pretrain_loss
    from paddle_tpu_torch.parallel import LoopbackWorld
    mask = args[3] if len(args) > 3 else None

    def fn(rank, mesh):
        m = models[rank]
        m.apply_mesh(mesh)
        if fault is not None:
            fault(m)
        with torch.inference_mode():
            lg = m(args[0], attention_mask=mask)[0]
            loss = float(bert_pretrain_loss(m, *args[:3],
                                            attention_mask=mask))
        torch.cuda.synchronize()
        return (lg if rank == 0 else None), loss
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = LoopbackWorld(len(models)).run(fn, axes={"mp": 2})
    return out[0][0], [o[1] for o in out], time.perf_counter() - t0


def _bert_train_ranks(base, args, steps):
    """``steps`` O2 ShardedTrainStep steps of two copies of ``base`` at
    mp = 2: ([each rank's (losses, gathered parameters (rank 0's on the
    host), parameter bytes, host-hop bytes a step)], host s a step)."""
    import copy

    import torch
    from paddle_tpu_torch.models import bert_pretrain_loss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import LoopbackWorld, ShardedTrainStep, tp
    models = [copy.deepcopy(base) for _ in range(2)]
    mask = args[3] if len(args) > 3 else None

    def loss(m, ids, mlm, nsp):
        return bert_pretrain_loss(m, ids, mlm, nsp, attention_mask=mask)

    def fn(rank, mesh):
        m = models[rank]
        step = ShardedTrainStep(m, loss, AdamW(learning_rate=1e-4),
                                mesh=mesh, amp_level="O2",
                                amp_dtype="bfloat16")
        pbytes = sum(p.numel() * p.element_size() for p in m.parameters())
        tp.reset_host_bytes()
        losses = [float(step(*args[:3])) for _ in range(steps)]
        hop = tp.host_bytes() / steps
        full = step.gather_params()
        full = {n: t.detach().cpu() for n, t in full.items()} \
            if rank == 0 else {n: t.detach().clone() for n, t in full.items()}
        return losses, full, pbytes, hop
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = LoopbackWorld(2).run(fn, axes={"mp": 2})
    return out, (time.perf_counter() - t0) / steps


def bert_mp_phase(fa, fused_ce, power):
    """Phase 51: BERT-base (B=128, S=128, remat=False) at mp = 2 on two
    LoopbackWorld ranks, unpadded and padded: served in bf16 against
    mp = 1 beside the contiguous qkv cut; trained BERT_MP_STEPS O2 steps
    against one-rank TrainStep beside copy_to without its sum.  Returns
    the readings and the launches of #1-#3 (masked and not)."""
    import copy

    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import Bert, bert_base, bert_pretrain_loss
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bert_base(max_seq_len=BERT_S, remat=False)
    L = cfg.num_layers
    base = Bert(cfg, device="cuda")                   # f32, seed 0
    init = {n: p.detach().cpu() for n, p in base.named_parameters()}
    whole_bytes = sum(p.numel() * p.element_size() for p in base.parameters())
    ids, mlm, nsp, amask, mlm_pad = (
        torch.as_tensor(a, device="cuda")
        for a in bert_batch(cfg.vocab_size, BERT_B, BERT_S))
    batches = {"unpadded": (ids, mlm, nsp), "padded": (ids, mlm_pad, nsp,
                                                       amask)}
    log(f"bert-mp: BERT-base ({L} layers, {cfg.num_heads} heads of "
        f"{cfg.head_dim}, V={cfg.vocab_size}), B={BERT_B}, S={BERT_S}, "
        f"remat=False, at mp = 2 on two LoopbackWorld ranks (threads) on the "
        f"one card, {cfg.num_heads // 2} heads a rank: every time is the "
        "simulation's")
    row, launches = {}, {}
    one = copy.deepcopy(base).to(torch.bfloat16)
    full = {n: p.detach() for n, p in one.named_parameters()}
    for kind, args in batches.items():
        mask = args[3] if len(args) > 3 else None
        with torch.inference_mode():
            want_lg = one(ids, attention_mask=mask)[0]
            want_loss = float(bert_pretrain_loss(one, *args[:3],
                                                 attention_mask=mask))
        reset_counts(fa, fused_ce)
        lg, losses, sec = _bert_serve_ranks(
            [copy.deepcopy(one) for _ in range(2)], args)
        counts = kernel_counts(fa, fused_ce)
        _add(launches, counts)
        name = "flash_attention_fwd" + ("_masked" if mask is not None
                                        else "")
        flg, f_losses, _ = _bert_serve_ranks(
            [copy.deepcopy(one) for _ in range(2)], args,
            fault=lambda m: _contiguous_qkv(m, full))
        sv = {"logits_err": _norm_err(lg, want_lg),
              "logits_abs_err": float((lg.float() - want_lg.float()).abs()
                                      .max()),
              "loss_err": max(abs(x - want_loss) for x in losses),
              "losses": losses, "logits_and_loss_ms": sec * 1e3,
              "launches": {k: v for k, v in counts.items() if v},
              "fault_contiguous_qkv_logits_err": _norm_err(flg, want_lg),
              "fault_contiguous_qkv_loss_err": max(abs(x - want_loss)
                                                   for x in f_losses)}
        del flg, lg, want_lg
        log(f"bert-mp serve {kind} (bf16): gathered MLM logits against "
            f"mp = 1 {sv['logits_err']:.4g} in norm (limit "
            f"{BERT_MP_LOGITS_NORM}; max |err| {sv['logits_abs_err']:.4g}), "
            f"loss "
            f"{losses[0]:.6f} ({sv['loss_err']:.3g}, limit {TOL_LOSS_BF16}); "
            f"{sec * 1e3:.1f} ms for both forwards (host clock, both ranks); "
            f"planted contiguous qkv cut "
            f"{sv['fault_contiguous_qkv_logits_err']:.4g} on the logits, "
            f"{sv['fault_contiguous_qkv_loss_err']:.4g} on the loss; "
            f"launches {sv['launches']} [{power}]")
        if counts[name] != 2 * 2 * L or sum(counts.values()) != 2 * 2 * L:
            fail(f"bert-mp serve {kind}: launches {counts}, not {L} of "
                 f"{name} a rank a forward and nothing else")
        if losses[0] != losses[1]:
            fail(f"bert-mp serve {kind}: the ranks' losses differ {losses}")
        if sv["logits_err"] > BERT_MP_LOGITS_NORM or \
                sv["loss_err"] > TOL_LOSS_BF16:
            fail(f"bert-mp: the mp = 2 forward disagrees with mp = 1 "
                 f"({kind})")
        if not (sv["fault_contiguous_qkv_logits_err"] > BERT_MP_LOGITS_NORM or
                sv["fault_contiguous_qkv_loss_err"] > TOL_LOSS_BF16):
            fail("bert-mp: the planted contiguous qkv cut was not caught")
        row[f"serve_{kind}"] = sv
        torch.cuda.empty_cache()
    del one, full

    for kind, args in batches.items():
        mask = args[3] if len(args) > 3 else None
        ref = copy.deepcopy(base)
        ts = TrainStep(ref, bert_pretrain_loss, AdamW(learning_rate=1e-4),
                       amp_level="O2", amp_dtype="bfloat16")
        want_l = [float(ts(*args)) for _ in range(BERT_MP_STEPS)]
        want_p = {n: p.detach().cpu() for n, p in ref.named_parameters()}
        del ts, ref
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts(fa, fused_ce)
        out, step_s = _bert_train_ranks(base, args, BERT_MP_STEPS)
        peak = torch.cuda.max_memory_allocated() - held
        counts = {k: v for k, v in kernel_counts(fa, fused_ce).items() if v}
        _add(launches, counts)
        losses = out[0][0]
        loss_err = max(abs(a - b) for a, b in zip(losses, want_l))
        l2 = _move_l2(out[0][1], want_p, init)
        same = _ranks_equal(out)
        tr = {"losses": losses, "one_rank_losses": want_l,
              "loss_err": loss_err, "move_l2_err": l2, "ranks_equal": same,
              "param_bytes_per_rank": [o[2] for o in out],
              "param_bytes_whole": whole_bytes,
              "host_hop_bytes_per_rank_step": [o[3] for o in out],
              "step_ms": step_s * 1e3, "peak_bytes": peak,
              "launches_per_rank_step": {
                  k: v / (2 * BERT_MP_STEPS) for k, v in counts.items()}}
        del out
        torch.cuda.empty_cache()
        if mask is not None:
            with copy_to_without_sum():
                fout, _ = _bert_train_ranks(base, args, BERT_MP_STEPS)
            tr["fault_copy_to_without_sum"] = {
                "loss_err": max(abs(a - b) for a, b in zip(fout[0][0],
                                                           want_l)),
                "move_l2_err": _move_l2(fout[0][1], want_p, init)}
            del fout
            torch.cuda.empty_cache()
        log(f"bert-mp train {kind} at mp = 2 (O2 bf16, AdamW(1e-4), "
            f"{BERT_MP_STEPS} steps): losses {losses} against one-rank "
            f"TrainStep {want_l} (max {loss_err:.3g}, limit {TOL_LOSS_BF16}); "
            f"gathered parameters: the move's error {l2:.4g} of the move in "
            f"L2 (limit {BERT_MP_MOVE_L2}); both ranks' gathered parameters "
            f"bitwise equal: {same}; planted copy_to without its sum "
            f"{tr.get('fault_copy_to_without_sum', '-')}; parameter bytes a "
            f"rank {tr['param_bytes_per_rank']} against {whole_bytes} whole; "
            f"host hop {tr['host_hop_bytes_per_rank_step'][0]:.0f} bytes a "
            f"rank a step; {step_s * 1e3:.1f} ms a step (host clock, both "
            f"ranks), peak bytes {peak} above the {held} held before (both "
            f"ranks); launches a rank a step {tr['launches_per_rank_step']} "
            f"[{power}]")
        sfx = "_masked" if mask is not None else ""
        want_n = {f"flash_attention_fwd{sfx}": L,
                  f"flash_attention_bwd_dq{sfx}": L,
                  f"flash_attention_bwd_dkv{sfx}": L}
        if tr["launches_per_rank_step"] != want_n:
            fail(f"bert-mp train {kind}: launches a rank a step "
                 f"{tr['launches_per_rank_step']}, not {want_n}")
        if loss_err > TOL_LOSS_BF16 or l2 > BERT_MP_MOVE_L2 or not same:
            fail(f"bert-mp: mp = 2 training disagrees with one-rank "
                 f"TrainStep ({kind})")
        fault = tr.get("fault_copy_to_without_sum")
        if fault is not None and not (fault["loss_err"] > TOL_LOSS_BF16 or
                                      fault["move_l2_err"] > BERT_MP_MOVE_L2):
            fail("bert-mp: the planted copy_to without its sum was not "
                 "caught")
        row[f"train_{kind}"] = tr
    del base
    torch.cuda.empty_cache()
    return row, launches


def device_top(fn, n=4):
    """The ``n`` kernels with the most device time in one fn() traced by
    torch.profiler: [(name (cut to 60 characters), ms)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key[:60], e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    return [(k, round(ms, 3)) for k, ms in rows[:n]]


def _bce(m, a, x, y):
    from paddle_tpu_torch.nn import functional as TF
    return TF.binary_cross_entropy_with_logits(m(a, x), y).mean()


def _timed_steps(step, args):
    """bench.py's _timeit: PS_WARM steps, then PS_ITERS timed on the host's
    clock to a read of the last loss.  Returns (ms a step, last loss)."""
    for _ in range(PS_WARM):
        step(*args)
    last = None
    t0 = time.perf_counter()
    for _ in range(PS_ITERS):
        last = step(*args)
    last = float(last)
    return (time.perf_counter() - t0) * 1e3 / PS_ITERS, last


def _rel_err(got, want):
    """max |got - want| over max |want| (f32, host arrays or tensors)."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _small_rank_run(cls, device, init, batches, lazy=False):
    """3 Adam(1e-2) TrainStep steps of a small rank model from ``init``
    (bench.py's CPU size) on three batches: (losses, final parameters on
    the host, whether each table's rows touched only by the first batch
    moved at the later steps).  ``lazy`` plants the lazy table update:
    after each step the rows the batch did not touch are put back."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import load_named_params
    from paddle_tpu_torch.optimizer import Adam
    model = cls(10_000, 16, 26, 13, device=device)
    load_named_params(model, init)
    step = TrainStep(model, _bce, Adam(learning_rate=1e-2))
    tables = [p for n, p in model.named_parameters()
              if n.endswith(".weight") and p.shape[0] == 10_000]
    losses, after_one = [], None
    for j, (ids, x, y) in enumerate(batches):
        args = [torch.as_tensor(a, device=device) for a in (ids, x, y)]
        before = [t.detach().clone() for t in tables]
        losses.append(float(step(*args)))
        if lazy:
            keep = torch.ones(10_000, dtype=torch.bool, device=device)
            keep[args[0].reshape(-1).long()] = False
            with torch.no_grad():
                for t, b in zip(tables, before):
                    t[keep] = b[keep]
        if j == 0:
            after_one = [t.detach().clone() for t in tables]
    only_first = np.setdiff1d(batches[0][0], np.concatenate(
        [b[0].ravel() for b in batches[1:]]))
    idx = torch.as_tensor(only_first, device=device).long()
    moved = all(bool((t.detach()[idx] != a[idx]).any(dim=1).all())
                for t, a in zip(tables, after_one))
    return losses, {n: p.detach().cpu() for n, p in
                    model.named_parameters()}, moved


def widedeep_phase(power):
    """Phase 52: bench.py's bench_widedeep cell, WideDeep(1,000,000, 16,
    26, 13), B=4096, Adam(1e-3) under TrainStep, then DeepFM at the same
    shape: examples/s, peak bytes, idle share; each at bench.py's CPU size
    (10,000 features, B=256) card against CPU for 3 steps, beside the
    planted lazy table update."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import DeepFM, WideDeep
    from paddle_tpu_torch.optimizer import Adam
    B, feats = 4096, 1_000_000
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, feats, size=(B, 26)).astype(
        np.int32), device="cuda")
    x = torch.as_tensor(rng.standard_normal((B, 13)).astype(np.float32),
                        device="cuda")
    y = torch.as_tensor(rng.integers(0, 2, size=(B, 1)).astype(np.float32),
                        device="cuda")
    small = []
    srng = np.random.default_rng(1)
    for _ in range(3):
        small.append((srng.integers(0, 10_000, size=(256, 26)).astype(
            np.int64), srng.standard_normal((256, 13)).astype(np.float32),
            srng.integers(0, 2, size=(256, 1)).astype(np.float32)))
    row = {}
    for name, cls in (("widedeep", WideDeep), ("deepfm", DeepFM)):
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = cls(feats, 16, 26, 13, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        step = TrainStep(model, _bce, Adam(learning_rate=1e-3))
        first = float(step(ids, x, y))
        ms, last = _timed_steps(step, (ids, x, y))
        busy, _ = device_busy_ms(lambda: step(ids, x, y))
        peak = torch.cuda.max_memory_allocated() - held
        del step, model
        torch.cuda.empty_cache()
        init = {n: p.detach() for n, p in cls(
            10_000, 16, 26, 13, device="cpu").named_parameters()}
        c_l, c_p, c_moved = _small_rank_run(cls, "cuda", init, small)
        h_l, h_p, _ = _small_rank_run(cls, "cpu", init, small)
        _, _, lazy_moved = _small_rank_run(cls, "cuda", init, small,
                                           lazy=True)
        err = max(_rel_err(c_l, h_l), _move_l2(c_p, h_p, init))
        r = {"examples_per_s": B / ms * 1e3, "step_ms": ms,
             "first_loss": first, "last_loss": last, "peak_bytes": peak,
             "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / ms),
             "build_s": build_s, "small_card_vs_cpu_err": err,
             "small_first_only_rows_moved": c_moved,
             "fault_lazy_update_rows_moved": lazy_moved}
        metric = ("widedeep_sparse_train_examples_per_sec_per_chip"
                  if name == "widedeep" else "deepfm_train_examples_per_sec")
        log(f"{name}: {cls.__name__}(1,000,000, 16, 26, 13), B={B}, "
            f"Adam(1e-3), TrainStep: {metric} {r['examples_per_s']:.1f} "
            f"({ms:.3f} ms a step, host clock over {PS_ITERS} after "
            f"{PS_WARM} warm-ups), loss {first:.5f} -> {last:.5f}, "
            f"peak bytes {peak} above those held before, device busy "
            f"{busy:.3f} ms "
            f"(idle share {r['idle_share']:.3f}), built in {build_s:.1f} s; "
            f"at 10,000 features, B=256, 3 Adam(1e-2) steps card vs CPU "
            f"{err:.3g} (the losses relative, the parameters the move's L2 "
            f"error; limit {TOL_PS_F32}); rows touched only by the first "
            f"batch moved later: {c_moved} (planted lazy update: "
            f"{lazy_moved}) [{power}]")
        if not (math.isfinite(first) and last < first):
            fail(f"{name}: the loss did not fall ({first} -> {last})")
        if err > TOL_PS_F32:
            fail(f"{name}: the card disagrees with the CPU ({err:.3g})")
        if not c_moved or lazy_moved:
            fail(f"{name}: rows touched once moved later {c_moved}, under "
                 f"the planted lazy update {lazy_moved}")
        row[name] = r
    return row


def _ps_small(device, init, data, piped, table=None, after_step=None):
    """3 PSTrainStep steps of WideDeepHost(8, 26, 13, hidden (16,)) over a
    50,000 x 9 sync adagrad table (bench.py's CPU size, f32 transfer), a
    local one or ``table`` (a remote one): (losses, the local table or
    None, the model's parameters).  ``after_step(step)`` runs after each
    step."""
    import torch
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.models import WideDeepHost, load_named_params
    from paddle_tpu_torch.optimizer import Adam
    emb = ps.DistributedEmbedding(50_000, 9, mode="sync", table=table,
                                  device=device)
    model = WideDeepHost(8, 26, 13, hidden=(16,), device=device)
    load_named_params(model, init)
    step = ps.PSTrainStep(model, _bce, Adam(learning_rate=1e-3), emb,
                          transfer_dtype="float32",
                          prefetch_depth=1 if piped else 0, device=device)
    ids, x, y = data
    if piped:
        step.prefetch(ids[0])
    losses = []
    for j in range(3):
        if piped and j < 2:
            step.prefetch(ids[j + 1])
        losses.append(float(step(ids[j], torch.as_tensor(x[j], device=device),
                                 torch.as_tensor(y[j], device=device))))
        if after_step is not None:
            after_step(step)
    step.flush()
    local = getattr(emb.table, "_table", None)
    return losses, None if local is None else local.copy(), {
        n: p.detach().cpu() for n, p in model.named_parameters()}


def widedeep_ps_phase(power):
    """Phase 53: bench.py's bench_widedeep_ps first leg, WideDeepHost(64,
    26, 13) over a DistributedEmbedding(100,000,000, 65, adagrad, 0.05,
    async) host table, B=16384, ids zipf(1.3) % V, PSTrainStep unpipelined
    then prefetched: examples/s, the host ms of the unique prep, pull and
    push, the device's idle share, the table's host bytes and init
    seconds; one step's pushed gradient against the per-slot gradients
    summed over each id, beside a push that does not sum them; the card
    against the CPU at bench.py's CPU size, unpipelined and prefetched."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.models import WideDeepHost
    from paddle_tpu_torch.optimizer import Adam
    row = {}
    # the card against the CPU at bench.py's CPU size first (small)
    init = {n: p.detach() for n, p in WideDeepHost(
        8, 26, 13, hidden=(16,), device="cpu").named_parameters()}
    srng = np.random.default_rng(1)
    data = ((srng.zipf(1.3, size=(3, 256, 26)) % 50_000).astype(np.int64),
            srng.standard_normal((3, 256, 13)).astype(np.float32),
            srng.integers(0, 2, size=(3, 256, 1)).astype(np.float32))
    for piped in (False, True):
        c = _ps_small("cuda", init, data, piped)
        h = _ps_small("cpu", init, data, piped)
        err = max(_rel_err(c[0], h[0]), _rel_err(c[1], h[1]),
                  max(_rel_err(c[2][n], h[2][n]) for n in h[2]))
        what = "prefetched" if piped else "unpipelined"
        row[f"small_{what}_card_vs_cpu_err"] = err
        log(f"widedeep-ps at 50,000 x 9, B=256, f32 transfer, {what}: "
            f"3 steps card vs CPU (losses, table, dense) {err:.3g} (limit "
            f"{TOL_PS_F32})")
        if err > TOL_PS_F32:
            fail(f"widedeep-ps: the card disagrees with the CPU ({what})")

    t0 = time.perf_counter()
    emb = ps.DistributedEmbedding(PS_V, PS_E + 1, optimizer="adagrad",
                                  learning_rate=0.05, mode="async",
                                  device="cuda")
    init_s = time.perf_counter() - t0
    table = emb.table
    table_bytes = table._table.nbytes + table._g2.nbytes
    model = WideDeepHost(PS_E, PS_FIELDS, PS_DENSE, device="cuda")
    step = ps.PSTrainStep(model, _bce, Adam(learning_rate=1e-3), emb)
    rng = np.random.default_rng(0)
    ids = (rng.zipf(1.3, size=(PS_B, PS_FIELDS)) % PS_V).astype(np.int64)
    x = torch.as_tensor(rng.standard_normal((PS_B, PS_DENSE)).astype(
        np.float32), device="cuda")
    y = torch.as_tensor(rng.integers(0, 2, size=(PS_B, 1)).astype(
        np.float32), device="cuda")
    uniq, inv, uniq_p = ps.PSTrainStep._unique_prep(ids)
    log(f"widedeep-ps: host table {PS_V:,} x {PS_E + 1} adagrad, "
        f"{table_bytes} bytes of host RAM (table {table._table.nbytes}, "
        f"accumulator {table._g2.nbytes}), drawn in {init_s:.1f} s; B={PS_B}"
        f", {PS_FIELDS} fields, {len(uniq)} unique ids of {ids.size}, padded "
        f"to {len(uniq_p)}")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    first = float(step(ids, x, y))
    ms, last = _timed_steps(step, (ids, x, y))
    step.flush()
    busy, traced = device_busy_ms(lambda: step(ids, x, y))
    top = device_top(lambda: step(ids, x, y))
    step.flush()

    def piped():
        step.prefetch(ids)
        return step(ids, x, y)
    step.prefetch(ids)
    p_ms, p_last = _timed_steps(piped, ())
    step.flush()
    step.prefetch(ids)
    p_busy, _ = device_busy_ms(piped)
    step.flush()
    peak = torch.cuda.max_memory_allocated() - held
    # the host's parts of a step, each alone on this batch (mean of 5)
    host = {}
    for name, fn in (("unique_prep", lambda: ps.PSTrainStep._unique_prep(
            ids)), ("pull", lambda: table.pull(uniq_p)),
            ("push", lambda: table.push(uniq, np.zeros(
                (len(uniq), PS_E + 1), np.float32)))):
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        host[name] = (time.perf_counter() - t0) * 1e3 / 5

    # one step's pushed gradient against the per-slot gradients summed
    # over each id (the gather's backward), both bf16; the planted push
    # that does not sum them keeps each id's last slot
    pushed = []
    real_push = emb.communicator.push
    emb.communicator.push = lambda i, g: pushed.append((i, g))
    rows = ps.bf16_rows(table.pull(ids)).to("cuda").float().requires_grad_()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss = _bce(model, rows, x, y)
    per_slot = torch.autograd.grad(loss, rows)[0].reshape(-1, PS_E + 1)
    del rows
    inv_t = torch.as_tensor(inv, device="cuda")
    want = torch.zeros(len(uniq), PS_E + 1, device="cuda").index_add_(
        0, inv_t, per_slot).to(torch.bfloat16).float().cpu().numpy()
    last_slot = torch.zeros(len(uniq), PS_E + 1, device="cuda")
    last_slot[inv_t] = per_slot
    last_slot = last_slot.to(torch.bfloat16).float().cpu().numpy()
    step.prefetch_depth = 0
    step(ids, x, y)
    emb.communicator.push = real_push
    step.flush()
    moved = any(not torch.equal(p, params[n])
                for n, p in model.named_parameters())
    push_err = _rel_err(pushed[0][1], want)
    fault_err = _rel_err(last_slot, want)
    r = {"unpipelined_examples_per_s": PS_B / ms * 1e3,
         "unpipelined_step_ms": ms, "prefetched_examples_per_s":
         PS_B / p_ms * 1e3, "prefetched_step_ms": p_ms,
         "first_loss": first, "last_loss": last, "prefetched_last_loss":
         p_last, "unpipelined_device_busy_ms": busy,
         "unpipelined_traced_wall_ms": traced,
         "unpipelined_idle_share": max(0.0, 1 - busy / ms),
         "prefetched_device_busy_ms": p_busy,
         "prefetched_idle_share": max(0.0, 1 - p_busy / p_ms),
         "host_ms": host, "table_host_bytes": table_bytes,
         "table_init_s": init_s, "unique_ids": len(uniq),
         "padded_ids": len(uniq_p), "peak_bytes": peak,
         "push_err": push_err, "fault_push_without_sum_err": fault_err,
         "top_kernels": top}
    row.update(r)
    log(f"widedeep-ps: widedeep_ps_host_table_100M_examples_per_sec "
        f"{r['unpipelined_examples_per_s']:.1f} ({ms:.3f} ms a step, host "
        f"clock over {PS_ITERS} after {PS_WARM} warm-ups; loss {first:.5f} "
        f"-> {last:.5f}); prefetched {r['prefetched_examples_per_s']:.1f} "
        f"({p_ms:.3f} ms a step); host ms of the unique prep, pull and push "
        f"alone {host}; device busy {busy:.3f} ms a step (idle share "
        f"{r['unpipelined_idle_share']:.3f}; prefetched {p_busy:.3f}, "
        f"{r['prefetched_idle_share']:.3f}; top kernels {top}); peak bytes "
        f"{peak} above those held before; the pushed gradient against the "
        f"summed per-slot gradients "
        f"{push_err:.3g} (limit {TOL_PS_PUSH}), the planted push without the"
        f" sum {fault_err:.3g} [{power}]")
    # judged at the end of both legs: the async pushes of the unpipelined
    # leg run behind its steps (a push alone takes about a step's time),
    # so its rows may be many pushes stale and its loss above the first
    if not (math.isfinite(first) and p_last < first):
        fail(f"widedeep-ps: the loss did not fall ({first} -> {last}, "
             f"{p_last})")
    if push_err > TOL_PS_PUSH or not fault_err > TOL_PS_PUSH or not moved:
        fail("widedeep-ps: the pushed gradient is not the sum over each id, "
             "or the planted push without the sum passes")
    # the step and its table train on in widedeep-filefed (56), as
    # bench.py's file-fed leg reuses its first leg's step
    return row, {"step": step, "emb": emb}


@contextlib.contextmanager
def exchange_without_owner_mask():
    """The planted exchange fault: every rank sends the rows at its
    clipped offsets for every request, owned or not."""
    from paddle_tpu_torch.distributed.ps import device_table as dtab
    sound = dtab._Exchange.rows
    dtab._Exchange.rows = lambda self, w: w[self.clipped]
    try:
        yield
    finally:
        dtab._Exchange.rows = sound


def _dense_table_adam(step):
    """The planted dense-optimizer fault: the table updated as a dense
    parameter by Adam (its moments carry every row touched once)."""
    import torch
    state = {}

    def push(ex, dmine, rows_per):
        g = torch.zeros_like(step._w)
        dall = torch.where(ex.owned[:, None], dmine, torch.zeros_like(dmine))
        g.index_add_(0, ex.clipped, dall)
        m = state.setdefault("m", torch.zeros_like(g))
        v = state.setdefault("v", torch.zeros_like(g))
        m.mul_(0.9).add_(g, alpha=0.1)
        v.mul_(0.999).addcmul_(g, g, value=0.001)
        step._w.sub_(step.table_lr * m / (v.sqrt() + 1e-8))
    step._push = push


def _device_small(k, init, data, sum_loss, plant=None):
    """3 DeviceEmbeddingTrainStep steps of WideDeepHost(8, 26, 13,
    hidden (16,)) from ``init`` over a 50,000 x 9 table on the card, on k
    LoopbackWorld ranks (one rank with no mesh at k = 1): (rank 0's
    losses, the whole table, whether the rows each step left untouched
    stayed unchanged)."""
    import torch
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.models import WideDeepHost, load_named_params
    from paddle_tpu_torch.optimizer import SGD, Adam
    from paddle_tpu_torch.parallel import LoopbackWorld
    ids, x, y = data

    def loss(m, rows, xb, yb):
        if sum_loss:
            from paddle_tpu_torch.nn import functional as TF
            return TF.binary_cross_entropy_with_logits(
                m(rows, xb), yb, reduction="sum")
        return _bce(m, rows, xb, yb)

    def fn(rank, mesh):
        model = WideDeepHost(8, 26, 13, hidden=(16,), device="cuda")
        load_named_params(model, init)
        emb = ps.MeshShardedEmbedding(50_000, 9, device="cuda")
        opt = SGD(learning_rate=0.0) if sum_loss else Adam(1e-3)
        step = ps.DeviceEmbeddingTrainStep(model, loss, opt, emb)
        if plant is not None:
            plant(step)
        losses, still = [], True
        for j in range(3):
            before = step._w.clone()
            losses.append(float(step(*(torch.as_tensor(a[j], device="cuda")
                                       for a in (ids, x, y)))))
            lo = (rank if mesh is not None else 0) * step._w.shape[0]
            hit = torch.zeros(step._w.shape[0], dtype=torch.bool,
                              device="cuda")
            local = torch.as_tensor(ids[j], device="cuda").reshape(-1) - lo
            hit[local[(local >= 0) & (local < hit.numel())]] = True
            still = still and torch.equal(step._w[~hit], before[~hit])
        return losses, step.sync_table().detach().cpu(), still
    out = (LoopbackWorld(k).run(fn) if k > 1 else [fn(0, None)])
    return out[0][0], torch.cat([o[1] for o in out]).numpy(), all(
        o[2] for o in out)


def widedeep_device_phase(power):
    """Phase 54: bench.py's bench_widedeep_device cell,
    MeshShardedEmbedding(10,000,000, 65) on the card, WideDeepHost(64, 26,
    13), B=16384, DeviceEmbeddingTrainStep at K = 1: examples/s, peak
    bytes, idle share; then at bench.py's CPU size K = 2 (LoopbackWorld
    threads) against K = 1 with a sum loss, the untouched rows unchanged,
    beside a dense Adam over the table and an exchange without the owner
    mask."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.models import WideDeepHost
    from paddle_tpu_torch.optimizer import Adam
    B, V, E = PS_B, 10_000_000, PS_E
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    emb = ps.MeshShardedEmbedding(V, E + 1, mesh_axis="dp", seed=0,
                                  device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = WideDeepHost(E, PS_FIELDS, PS_DENSE, device="cuda")
    step = ps.DeviceEmbeddingTrainStep(model, _bce, Adam(learning_rate=1e-3),
                                       emb, table_lr=0.05)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor((rng.zipf(1.3, size=(B, PS_FIELDS)) % V).astype(
        np.int32), device="cuda")
    x = torch.as_tensor(rng.standard_normal((B, PS_DENSE)).astype(
        np.float32), device="cuda")
    y = torch.as_tensor(rng.integers(0, 2, size=(B, 1)).astype(np.float32),
                        device="cuda")
    first = float(step(ids, x, y))
    ms, last = _timed_steps(step, (ids, x, y))
    busy, _ = device_busy_ms(lambda: step(ids, x, y))
    top = device_top(lambda: step(ids, x, y))
    peak = torch.cuda.max_memory_allocated() - held
    table_bytes = step._w.numel() * 4
    del step, emb, model
    torch.cuda.empty_cache()

    srng = np.random.default_rng(2)
    data = ((srng.zipf(1.3, size=(3, 256, 26)) % 50_000).astype(np.int64),
            srng.standard_normal((3, 256, 13)).astype(np.float32),
            srng.integers(0, 2, size=(3, 256, 1)).astype(np.float32))
    init = {n: p.detach() for n, p in WideDeepHost(
        8, 26, 13, hidden=(16,), device="cpu").named_parameters()}
    l1, w1, still1 = _device_small(1, init, data, True)
    l2, w2, still2 = _device_small(2, init, data, True)
    k2_err = max(_rel_err(w2, w1), _rel_err([2 * v for v in l2], l1))
    with exchange_without_owner_mask():
        _, fw, _ = _device_small(2, init, data, True)
    mask_err = _rel_err(fw, w1)
    _, _, dense_still = _device_small(1, init, data, False,
                                      plant=_dense_table_adam)
    _, _, adam_still = _device_small(1, init, data, False)
    r = {"examples_per_s": B / ms * 1e3, "step_ms": ms, "first_loss": first,
         "last_loss": last, "peak_bytes": peak, "table_bytes": table_bytes,
         "table_init_s": init_s, "device_busy_ms": busy,
         "idle_share": max(0.0, 1 - busy / ms), "top_kernels": top,
         "small_k2_vs_k1_err": k2_err,
         "small_untouched_rows_still": [still1, still2, adam_still],
         "fault_exchange_without_owner_mask_err": mask_err,
         "fault_dense_table_adam_untouched_still": dense_still}
    log(f"widedeep-device: MeshShardedEmbedding({V:,}, {E + 1}) on the card "
        f"({table_bytes} bytes, drawn in {init_s:.1f} s), WideDeepHost, "
        f"B={B}, DeviceEmbeddingTrainStep at K = 1: "
        f"widedeep_device_sharded_10M_examples_per_sec "
        f"{r['examples_per_s']:.1f} ({ms:.3f} ms a step, host clock over "
        f"{PS_ITERS} after {PS_WARM} warm-ups; loss {first:.5f} -> "
        f"{last:.5f}), peak bytes {peak} above those held before, device "
        f"busy "
        f"{busy:.3f} ms (idle share {r['idle_share']:.3f}; top kernels "
        f"{top}); at 50,000 x 9, "
        f"B=256, a sum loss: K = 2 against K = 1 {k2_err:.3g} (limit "
        f"{TOL_PS_F32}), untouched rows unchanged "
        f"{r['small_untouched_rows_still']}; planted exchange without the "
        f"owner mask {mask_err:.3g}, dense "
        f"Adam over the table leaves untouched rows unchanged: "
        f"{dense_still} [{power}]")
    if not (math.isfinite(first) and last < first):
        fail(f"widedeep-device: the loss did not fall ({first} -> {last})")
    if k2_err > TOL_PS_F32 or not (still1 and still2 and adam_still):
        fail("widedeep-device: K = 2 disagrees with K = 1, or an untouched "
             "row moved")
    if not mask_err > TOL_PS_F32 or dense_still:
        fail("widedeep-device: a planted fault was not caught")
    row = dict(r)
    return row


# -- the host planes (phase 55) ----------------------------------------------
PLANES_STEPS = 3               # planes: GPT-2 345M steps under the profiler
PLANES_SYNC_STEPS = 3          # planes: steps whose synchronisations count
# the flash kernels' names in the profiler's trace, by their launch counter
PLANES_KERNELS = (("launches", "fa_fwd_wgmma_kernel"),
                  ("launches_dq", "fa_bwd_dq_wgmma_kernel"),
                  ("launches_dkv", "fa_bwd_dkv_wgmma_kernel"))


def planes_reset():
    """A clean slate of the host planes: statistics and histograms at 0,
    no detectors, compile sites or memory samples, an empty flight ring."""
    from paddle_tpu_torch.framework import health, monitor, observability
    monitor.reset_all_stats()
    monitor.reset_all_histograms()
    health.reset()
    observability.flight.clear()


def count_syncs(fn):
    """(the synchronising CUDA calls fn() makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them, fn's host
    ms)."""
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught), ms


@contextlib.contextmanager
def loss_read_in_hook(tjit):
    """Planted fault: the step's statistics hook reads the loss back to the
    host (``.item()``), a synchronisation the planes must not add."""
    record = tjit._record_step

    def reading(step, losses, steps, t_start):
        float(losses.sum())
        return record(step, losses, steps, t_start)
    tjit._record_step = reading
    try:
        yield
    finally:
        tjit._record_step = record


def kernels_in_range(path, fragments, range_name):
    """Of a torch.profiler chrome trace: {fragment: (kernels whose name
    holds it, those whose launch call lies inside a ``range_name`` host
    range)}, and the number of such ranges.  A kernel meets its launch
    call by the trace's correlation id."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == range_name and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in (e.get("args") or {})}
    out = {}
    for frag in fragments:
        ks = [e for e in events
              if e.get("cat") == "kernel" and frag in e.get("name", "")]
        inside = sum(any(a <= launch_ts.get(
            (k.get("args") or {}).get("correlation"), -1.0) <= b
            for a, b in ranges) for k in ks)
        out[frag] = (len(ks), inside)
    return out, len(ranges)


def planes_phase(cfg, ids_t, fa, power):
    """Phase 55: the host planes on GPT-2 345M's O2 TrainStep (AdamW
    1e-4), as the train phase builds it.  PLANES_STEPS steps run under the
    tracer, a memory sample every step and ``profiler.start_profiler
    ("All")``: the span file's train.step spans and ``span_summary``, the
    step statistics, the compile site (one compile, the rest cache hits),
    the memory gauge against the allocator read at the sample, the
    watermark event, and the flash kernels in the profiler's chrome trace
    as many times as their launch counters rose, each launched inside a
    ``TrainStep`` range.  Then the synchronisations of PLANES_SYNC_STEPS
    steps under ``set_sync_debug_mode("warn")`` with the planes off and on
    (tracer, memory sample, detectors, profiler table) must be equal, and
    a hook planted to read the loss must raise them.  Last, a small GPT
    under ShardedUpdateTrainStep at world size 1 (a one-rank
    LoopbackWorld) with ``zero.collective`` armed nth=1 gives the unarmed
    run's losses and parameters bitwise, with one retry counted."""
    import copy
    import tempfile

    import numpy as np
    import torch
    import paddle_tpu_torch.jit as tjit
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.framework import (chaos, health, monitor,
                                            observability)
    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    from paddle_tpu_torch.models import GPT, gpt_loss, gpt_tiny
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import LoopbackWorld
    from paddle_tpu_torch.parallel.zero import ShardedUpdateTrainStep
    tracer = observability.tracer
    tmp = tempfile.mkdtemp(prefix="planes_")
    trace_dir, prof_dir = os.path.join(tmp, "trace"), os.path.join(tmp,
                                                                   "prof")
    saved = get_flags(["health_mem_sample_every", "health_detectors"])
    model = GPT(cfg, device="cuda")
    step = tjit.TrainStep(model, gpt_loss, AdamW(learning_rate=1e-4),
                          amp_level="O2", amp_dtype="bfloat16")
    torch.cuda.synchronize()
    planes_reset()
    reset_fa(fa)
    at_sample = []                  # the allocator, read at each sample

    def sample(tags=None):
        got = health.MemoryTracker.sample(health.memory, tags)
        at_sample.append(torch.cuda.memory_allocated())
        return got
    health.memory.sample = sample
    set_flags({"health_mem_sample_every": 1})
    tracer.enable(trace_dir, label="planes")
    profiler.start_profiler("All", trace_dir=prof_dir)
    try:
        for _ in range(PLANES_STEPS):
            step(ids_t, ids_t)
        torch.cuda.synchronize()
    finally:
        profiler.stop_profiler(profile_path=os.path.join(tmp, "host.json"))
        tracer.disable()
        del health.memory.sample
        set_flags(saved)
    counts = dict(zip(FA_COUNTERS, fa_counts(fa)))
    stats = monitor.all_stats()
    r = {"steps": PLANES_STEPS}
    with open(os.path.join(trace_dir, "trace_planes.jsonl")) as f:
        spans = [json.loads(line) for line in f]
    r["train_step_span_steps"] = [s["attrs"]["step"] for s in spans
                                  if s.get("name") == "train.step"]
    r["span_summary"] = {row["name"]: row["count"] for row in
                         observability.span_summary(trace_dir)}
    r["train_steps_total"] = stats.get("train_steps_total")
    r["train_step_ms_count"] = monitor.all_histograms()[
        "train_step_ms"]["count"]
    rep = health.compile_report()["TrainStep"]
    r["compile"] = {k: rep[k] for k in ("calls", "compiles", "causes")}
    r["cache_hits"] = stats.get("jit_cache_hits_total")
    r["compile_ms"] = rep["compile_ms_total"]
    r["mem_live_bytes"] = stats["device_mem_live_bytes"]
    r["mem_allocated_at_sample"] = at_sample[-1]
    r["mem_peak_bytes"] = stats["device_mem_peak_bytes"]
    r["mem_params_bytes"] = stats["device_mem_params_bytes"]
    params_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    r["watermarks"] = len(observability.flight.recent(
        50, kind="health.mem_watermark"))
    traces = glob.glob(os.path.join(prof_dir, "device_trace.*.json"))
    frags = [name for _, name in PLANES_KERNELS]
    in_trace, n_ranges = kernels_in_range(traces[0], frags, "TrainStep") \
        if len(traces) == 1 else ({f: (0, 0) for f in frags}, 0)
    r["trace_kernels"] = {f: list(v) for f, v in in_trace.items()}
    r["trace_train_step_ranges"] = n_ranges
    r["launch_counters"] = {c: counts[c] for c, _ in PLANES_KERNELS}
    log(f"planes: {PLANES_STEPS} O2 steps under the tracer, a memory sample "
        f"a step and start_profiler('All'): train.step spans "
        f"{r['train_step_span_steps']}, span_summary {r['span_summary']}, "
        f"train_steps_total {r['train_steps_total']}, train_step_ms count "
        f"{r['train_step_ms_count']}; compile site {r['compile']} "
        f"({r['compile_ms']:.1f} ms), cache hits {r['cache_hits']}; "
        f"device_mem_live_bytes {r['mem_live_bytes']} (allocator at the "
        f"sample {r['mem_allocated_at_sample']}), peak {r['mem_peak_bytes']}, "
        f"params {r['mem_params_bytes']} (model {params_bytes}), "
        f"{r['watermarks']} watermark event(s); profiler trace "
        f"{len(traces)} file(s), {n_ranges} TrainStep ranges, kernels "
        f"(in trace, launched inside a TrainStep range) "
        f"{r['trace_kernels']} vs launch counters {r['launch_counters']}")
    if r["train_step_span_steps"] != list(range(PLANES_STEPS)) or \
            r["span_summary"].get("train.step") != PLANES_STEPS:
        fail("planes: the trace does not hold one train.step span a step")
    if r["train_steps_total"] != PLANES_STEPS or \
            r["train_step_ms_count"] != PLANES_STEPS:
        fail("planes: train_steps_total or train_step_ms miscounts")
    if r["compile"]["compiles"] != 1 or r["compile"]["causes"] != {
            "new_signature": 1} or r["cache_hits"] != PLANES_STEPS - 1:
        fail("planes: the TrainStep compile site miscounts")
    if r["mem_live_bytes"] != r["mem_allocated_at_sample"] or \
            r["mem_peak_bytes"] < r["mem_live_bytes"] or \
            r["mem_params_bytes"] != params_bytes or not r["watermarks"]:
        fail("planes: the memory gauge disagrees with the allocator")
    for counter, frag in PLANES_KERNELS:
        n, inside = in_trace[frag]
        if not n or n != counts[counter] or inside != n:
            fail(f"planes: the profiler's trace holds {n} {frag} ({inside} "
                 f"inside a TrainStep range), the counter rose "
                 f"{counts[counter]}")

    # the synchronisations of the steps, planes off and on
    def steps():
        for _ in range(PLANES_SYNC_STEPS):
            step(ids_t, ids_t)
    torch.cuda.synchronize()
    planes_reset()
    off_syncs, off_ms = count_syncs(steps)
    torch.cuda.synchronize()
    set_flags({"health_mem_sample_every": 1, "health_detectors": "default"})
    health._monitor.arm_from_flags(force=True)
    tracer.enable(trace_dir, label="planes_sync")
    profiler.start_profiler("CPU")
    try:
        on_syncs, on_ms = count_syncs(steps)
        torch.cuda.synchronize()
        with loss_read_in_hook(tjit):
            planted_syncs, _ = count_syncs(steps)
        torch.cuda.synchronize()
    finally:
        profiler.stop_profiler(profile_path=os.path.join(tmp, "host2.json"))
        tracer.disable()
        set_flags(saved)
        health.reset()
    r["syncs_unarmed"], r["syncs_armed"] = off_syncs, on_syncs
    r["syncs_planted_loss_read"] = planted_syncs
    r["host_ms_per_step_unarmed"] = off_ms / PLANES_SYNC_STEPS
    r["host_ms_per_step_armed"] = on_ms / PLANES_SYNC_STEPS
    log(f"planes: synchronisations of {PLANES_SYNC_STEPS} steps "
        f"(set_sync_debug_mode('warn')) unarmed {off_syncs}, armed "
        f"{on_syncs}, planted loss read in the hook {planted_syncs}; host "
        f"ms a step unarmed {r['host_ms_per_step_unarmed']:.2f}, armed "
        f"{r['host_ms_per_step_armed']:.2f} [{power}]")
    if on_syncs != off_syncs:
        fail("planes: the hooks add a device synchronisation")
    if planted_syncs <= off_syncs:
        fail("planes: a loss read in the hook was not counted")
    del step, model
    torch.cuda.empty_cache()

    # zero.collective armed on a small GPT at world size 1
    small = gpt_tiny(num_layers=2, max_seq_len=128)
    torch.manual_seed(0)
    base = GPT(small, device="cuda")
    ids_small = torch.as_tensor(np.random.default_rng(1).integers(
        0, small.vocab_size, (4, 128)), device="cuda")

    def zero_run(spec):
        def fn(rank, mesh):
            m = copy.deepcopy(base)
            zs = ShardedUpdateTrainStep(m, gpt_loss,
                                        AdamW(learning_rate=1e-3),
                                        mesh=mesh, wire_dtype="f32")
            losses = [zs(ids_small, ids_small).clone() for _ in range(2)]
            return losses, [p.detach().clone() for p in m.parameters()]
        if spec is None:
            return LoopbackWorld(1).run(fn)[0]
        with chaos.inject("zero.collective", mode="error", **spec):
            return LoopbackWorld(1).run(fn)[0]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain = zero_run(None)
        planes_reset()
        armed = zero_run({"nth": 1})
    finally:
        torch.use_deterministic_algorithms(was)
    counts = dict(zip(FA_COUNTERS, fa_counts(fa)))
    r["zero_retries_total"] = monitor.get_stat(
        "zero_collective_retries_total")
    r["zero_losses"] = [float(x) for x in armed[0]]
    r["zero_bitwise"] = all(torch.equal(a, b) for a, b in zip(
        plain[0] + plain[1], armed[0] + armed[1]))
    log(f"planes: ShardedUpdateTrainStep (gpt_tiny, 2 layers, world size 1) "
        f"with zero.collective armed nth=1: losses {r['zero_losses']}, "
        f"losses and parameters bitwise the unarmed run's "
        f"{r['zero_bitwise']}, zero_collective_retries_total "
        f"{r['zero_retries_total']}")
    if not r["zero_bitwise"] or r["zero_retries_total"] != 1:
        fail("planes: the retried zero.collective fault changed the step "
             "or miscounted")
    del base
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    return r, {"flash_attention_fwd": counts["launches"],
               "flash_attention_bwd_dq": counts["launches_dq"],
               "flash_attention_bwd_dkv": counts["launches_dkv"]}


# -- the PS transport, datasets and graph table (phases 56-58) ---------------
FF_FILES = 4                   # widedeep-filefed: slot files, as bench.py
FF_EPOCHS = 2                  # widedeep-filefed: train_from_dataset passes
# ogbn-arxiv's published size (nodes, directed edges, feature width,
# classes); drawn from the seed, no data is read
GRAPH_N, GRAPH_E, GRAPH_D, GRAPH_C = 169_343, 1_166_243, 128, 40
# GraphSAGE's first-layer fanout S1, roots a batch, steps
GRAPH_FANOUT, GRAPH_ROOTS, GRAPH_STEPS = 25, 1024, 20


def _write_slot_files(root, n_ex, fields, dense_dim, vocab):
    """bench.py's _gen_slot_dataset: FF_FILES multi-slot text files of
    ``fields`` one-id slots (zipf(1.3) % vocab), a ``dense_dim``-float
    slot and a label, from default_rng(11).  Returns the paths."""
    import numpy as np
    rng = np.random.default_rng(11)
    per = n_ex // FF_FILES
    paths = []
    for fi in range(FF_FILES):
        ids = (rng.zipf(1.3, size=(per, fields)) % vocab).astype(np.int64)
        dense = rng.standard_normal((per, dense_dim)).astype(np.float32)
        y = rng.integers(0, 2, size=(per,))
        path = os.path.join(root, f"part-{fi:03d}.txt")
        with open(path, "w") as f:
            for r in range(per):
                parts = [f"1 {v}" for v in ids[r]]
                parts.append(f"{dense_dim} " + " ".join(
                    f"{v:.4f}" for v in dense[r]))
                parts.append(f"1 {y[r]}")
                f.write(" ".join(parts) + "\n")
        paths.append(path)
    return paths


def _plain_slot_parse(paths, slots):
    """Every record of ``paths`` in order, parsed in Python: {name: float32
    (n, dim)} for a dense slot, {name: (ids, lengths)} for a sparse one."""
    import numpy as np
    vals = {name: [] for name, _, _ in slots}
    lens = {name: [] for name, kind, _ in slots if kind == "u"}
    for path in paths:
        with open(path) as f:
            for line in f:
                tok = line.split()
                i = 0
                for name, kind, _ in slots:
                    n = int(tok[i])
                    vals[name].extend(tok[i + 1:i + 1 + n])
                    if kind == "u":
                        lens[name].append(n)
                    i += 1 + n
    out = {}
    for name, kind, dim in slots:
        if kind == "f":
            out[name] = np.asarray([float(v) for v in vals[name]],
                                   np.float64).astype(np.float32).reshape(
                                       -1, dim)
        else:
            out[name] = (np.asarray([int(v) for v in vals[name]], np.int64),
                         np.asarray(lens[name], np.int64))
    return out


def widedeep_filefed_phase(power, keep, ps_row):
    """Phase 56: bench.py's bench_widedeep_ps file-fed leg. 98,304
    examples (B * 6) in bench.py's slot files under a temporary directory:
    the native datafeed's drain at 4 threads (examples/s, MB/s), its
    batches at 1 thread against a plain Python parse of the same files,
    phase 53's PSTrainStep (100,000,000 x 65 adagrad host table, B=16384)
    fed from the files (examples/s and its ratio to phase 53's
    unpipelined step), then train_from_dataset through a QueueDataset
    and through an InMemoryDataset after local_shuffle, the 26 slots
    stacked as bench.py's batches(), 2 epochs each: finite losses, the
    last epoch's mean below the first's (the labels are random: the model
    learns the examples it has seen).  Drops phase 53's step and table at
    the end."""
    import tempfile

    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import DatasetFactory, train_from_dataset
    from paddle_tpu_torch.ops.native import MultiSlotDataFeed, lib_path
    step = keep["step"]
    n_ex = PS_B * 6
    slots = [(f"c{i}", "u", 1) for i in range(PS_FIELDS)] + [
        ("dense", "f", PS_DENSE), ("label", "f", 1)]
    root = tempfile.mkdtemp(prefix="widedeep_filefed_")
    r = {}
    try:
        t0 = time.perf_counter()
        files = _write_slot_files(root, n_ex, PS_FIELDS, PS_DENSE, PS_V)
        r["write_s"] = time.perf_counter() - t0
        slot_bytes = sum(os.path.getsize(f) for f in files)
        r["slot_bytes"] = slot_bytes
        t0 = time.perf_counter()
        MultiSlotDataFeed(slots, 1, files=[])     # builds the library
        r["datafeed_build_s"] = time.perf_counter() - t0
        log(f"widedeep-filefed: {n_ex} examples in {FF_FILES} files, "
            f"{slot_bytes} bytes, written in {r['write_s']:.2f} s; datafeed "
            f"library {lib_path()} ready in {r['datafeed_build_s']:.2f} s "
            f"[{power}]")

        n_p = 0
        t0 = time.perf_counter()
        for b in MultiSlotDataFeed(slots, PS_B, files=files, nthreads=4):
            n_p += len(b["label"])
        dt = time.perf_counter() - t0
        r["ingest_examples_per_s"] = n_p / dt
        r["ingest_mb_per_s"] = slot_bytes / dt / 1e6
        log(f"widedeep-filefed: datafeed_ingest_examples_per_sec "
            f"{r['ingest_examples_per_s']:.1f}, datafeed_ingest_mb_per_sec "
            f"{r['ingest_mb_per_s']:.2f} ({n_p} examples, 4 threads, "
            f"B={PS_B}, {dt:.3f} s) [{power}]")
        if n_p != n_ex:
            fail(f"widedeep-filefed: the datafeed gave {n_p} of {n_ex}")

        t0 = time.perf_counter()
        one = list(MultiSlotDataFeed(slots, PS_B, files=files, nthreads=1))
        t1 = time.perf_counter()
        plain = _plain_slot_parse(files, slots)
        t2 = time.perf_counter()
        same = [len(b["label"]) for b in one] == [PS_B] * 6
        for name, kind, _ in slots:
            if kind == "f":
                same = same and np.array_equal(
                    np.concatenate([b[name] for b in one]), plain[name])
            else:
                for j in range(2):
                    same = same and np.array_equal(np.concatenate(
                        [b[name][j] for b in one]), plain[name][j])
        r["one_thread_s"], r["plain_parse_s"] = t1 - t0, t2 - t1
        r["parse_check_bitwise"] = bool(same)
        log(f"widedeep-filefed: 1-thread datafeed {len(one)} batches in "
            f"{t1 - t0:.3f} s, bitwise a plain Python parse of the files "
            f"({t2 - t1:.2f} s): {same} [{power}]")
        del one, plain
        if not same:
            fail("widedeep-filefed: the datafeed's batches differ from the "
                 "plain parse")

        def stacked(b):
            return (np.stack([b[f"c{i}"][0] for i in range(PS_FIELDS)], 1),
                    torch.as_tensor(b["dense"], device="cuda"),
                    torch.as_tensor(b["label"], device="cuda"))

        def batches():
            for b in MultiSlotDataFeed(slots, PS_B, files=files, nthreads=4):
                if len(b["label"]) == PS_B:
                    yield stacked(b)

        loss = step(*next(batches()))          # warm, as bench.py
        float(loss)
        n_t = 0
        t0 = time.perf_counter()
        for args in batches():
            loss = step(*args)
            n_t += PS_B
        float(loss)
        step.flush()
        dt = time.perf_counter() - t0
        r["filefed_examples_per_s"] = n_t / dt
        r["filefed_vs_unpipelined"] = r["filefed_examples_per_s"] / ps_row[
            "unpipelined_examples_per_s"]
        log(f"widedeep-filefed: widedeep_ps_filefed_examples_per_sec "
            f"{r['filefed_examples_per_s']:.1f} ({n_t} examples in "
            f"{dt:.3f} s, ingest inside the timed loop), "
            f"{r['filefed_vs_unpipelined']:.3f} of phase 53's unpipelined "
            f"{ps_row['unpipelined_examples_per_s']:.1f} [{power}]")

        losses = {}
        for kind in ("QueueDataset", "InMemoryDataset"):
            ds = DatasetFactory().create_dataset(kind)
            ds.set_batch_size(PS_B)
            ds.set_thread(4)
            ds.set_filelist(files)
            ds.set_use_var(slots)
            load_s = 0.0
            if kind == "InMemoryDataset":
                t0 = time.perf_counter()
                ds.load_into_memory()
                ds.local_shuffle()
                load_s = time.perf_counter() - t0
            seen = []
            t0 = time.perf_counter()
            means = train_from_dataset(
                step, ds, converter=lambda b: list(stacked(b)),
                epochs=FF_EPOCHS, print_period=1,
                fetch_handler=lambda i, v: seen.append(v))
            step.flush()
            dt = time.perf_counter() - t0
            losses[kind] = means
            r[f"{kind}_s"] = dt
            r[f"{kind}_load_s"] = load_s
            r[f"{kind}_examples_per_s"] = FF_EPOCHS * n_ex / dt
            r[f"{kind}_epoch_losses"] = means
            r[f"{kind}_losses"] = seen
            log(f"widedeep-filefed: train_from_dataset over {kind}, "
                f"{FF_EPOCHS} epochs of {len(seen) // FF_EPOCHS} batches: "
                f"{FF_EPOCHS * n_ex / dt:.1f} examples/s ({dt:.3f} s; "
                f"load_into_memory and local_shuffle {load_s:.2f} s), epoch "
                f"mean losses {means}, batch losses {seen} [{power}]")
        # the labels are random: the loss falls as the model learns the
        # examples it has seen, epoch over epoch
        for kind, means in losses.items():
            if not (all(math.isfinite(v) for v in r[f"{kind}_losses"])
                    and means[-1] < means[0]):
                fail(f"widedeep-filefed: train_from_dataset's losses over "
                     f"{kind} are not finite and falling: {means}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        keep.clear()
        del step
    return r


def _compute_apps():
    """The card's compute processes as nvidia-smi lists them: [(pid,
    used memory)].  Inside a PID namespace the pids are the host's, so a
    process is told by the count of entries, not by its own pid."""
    smi = subprocess.run(["nvidia-smi",
                          "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return [tuple(x.strip() for x in line.split(","))
            for line in smi.stdout.splitlines() if line.strip()]


def start_remote_server():
    """Phase 57's server process, started ahead of the phase so its
    PS_V x (PS_E + 1) table draws while phases 54-56 run: (the process,
    its stderr file, its start time, the card's compute apps before it).
    It is killed at exit if the phase never ends it."""
    import atexit
    import tempfile

    from paddle_tpu_torch.distributed.ps.service import SERVER_BOOT
    here = os.path.dirname(os.path.abspath(__file__))
    err = tempfile.TemporaryFile(mode="w+")
    apps_before = _compute_apps()          # this trainer's context alone
    t_boot = time.perf_counter()
    srv = subprocess.Popen(
        [sys.executable, "-c", SERVER_BOOT, "--port", "0", "--table",
         f"emb:{PS_V}:{PS_E + 1}:adagrad:0.05", "--n-workers", "1"],
        stdout=subprocess.PIPE, stderr=err, text=True, cwd=here)
    atexit.register(lambda: srv.poll() is None and srv.kill())
    return srv, err, t_boot, apps_before


def widedeep_remote_phase(power, ps_row, server=None):
    """Phase 57: bench.py's bench_widedeep_ps remote leg.  A server process
    started through SERVER_BOOT with --table emb:100000000:65:adagrad:0.05
    --n-workers 1 (it draws its table while the small runs go); while it
    draws, at phase 53's small size (50,000 x 9, B=256, f32 wire,
    disjoint batches) 3 steps on the card against a remote table are
    bitwise 3 steps against a local one, unpipelined and prefetched, and
    once more with ps.rpc armed nth=1 (one retry).  Then PsClient on the
    default bf16 wire, DistributedEmbedding(async) over
    RemoteEmbeddingTable, WideDeepHost(64, 26, 13), Adam(1e-3),
    PSTrainStep looped with a prefetch before every step: examples/s and
    its ratio to phase 53's, the measured wire MB a step against
    bench.py's analytic f32 formula, device busy ms and idle share, the
    loss falls; the server adds no process to the card's compute apps,
    and it exits after the bye.  ``server``: start_remote_server()'s
    process, started earlier (a new one otherwise)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.distributed.ps.service import (
        PsClient, PsServer, RemoteEmbeddingTable)
    from paddle_tpu_torch.framework import chaos
    from paddle_tpu_torch.models import WideDeepHost
    from paddle_tpu_torch.optimizer import Adam
    r = {}
    srv, err, t_boot, apps_before = server or start_remote_server()
    try:
        # the card against a remote table at the small size, bitwise
        init = {n: p.detach() for n, p in WideDeepHost(
            8, 26, 13, hidden=(16,), device="cpu").named_parameters()}
        perm = np.random.default_rng(2).permutation(50_000)[:3 * 256 * 26]
        srng = np.random.default_rng(3)
        data = (perm.reshape(3, 256, 26).astype(np.int64),
                srng.standard_normal((3, 256, 13)).astype(np.float32),
                srng.integers(0, 2, size=(3, 256, 1)).astype(np.float32))

        def remote_small(piped, after_step=None):
            s = PsServer({"emb": ps.HostEmbeddingTable(50_000, 9)}).start()
            try:
                c = PsClient([f"127.0.0.1:{s.port}"], wire_dtype="f32",
                             backoff_base=0.01)
                out = _ps_small("cuda", init, data, piped,
                                table=RemoteEmbeddingTable(c, "emb", 9),
                                after_step=after_step)
                errors = c.transport_stats()["errors"]
                c.bye()
            finally:
                s.shutdown()
            return out[0], s.tables["emb"]._table, out[2], errors

        def same(a, b):
            return a[0] == b[0] and np.array_equal(a[1], b[1]) and all(
                torch.equal(a[2][n], b[2][n]) for n in a[2])

        clean = {}
        for piped in (False, True):
            what = "prefetched" if piped else "unpipelined"
            local = _ps_small("cuda", init, data, piped)
            clean[piped] = remote_small(piped)
            ok = same(local, clean[piped])
            r[f"small_{what}_remote_bitwise_local"] = ok
            log(f"widedeep-remote at 50,000 x 9, B=256, f32 wire, disjoint "
                f"batches, {what}: 3 steps on the card against a remote "
                f"table bitwise a local one (losses, table, dense): {ok}; "
                f"losses {clean[piped][0]} [{power}]")
            if not ok:
                fail(f"widedeep-remote: the remote table's run differs from "
                     f"the local one ({what})")
        chaos.reset(0)
        with chaos.inject("ps.rpc", mode="error", nth=1):
            faulted = remote_small(True)
            trips = chaos.stats()["ps.rpc"]["trips"]
        chaos.reset(0)
        ok = same(faulted, clean[True]) and trips == 1 and faulted[3] == 1
        r["small_rpc_fault_bitwise"] = ok
        log(f"widedeep-remote: ps.rpc armed nth=1 on the prefetched run: "
            f"{trips} trip, {faulted[3]} transport error retried, bitwise "
            f"the clean run: {ok} [{power}]")
        if not ok:
            fail("widedeep-remote: the retried ps.rpc fault changed the run")

        line = srv.stdout.readline()
        r["server_ready_s"] = time.perf_counter() - t_boot
        if not line.startswith("PS_READY"):
            err.seek(0)
            fail(f"widedeep-remote: the server did not start: {line!r} "
                 f"{err.read()[-800:]}")
        ep = line.split()[1]
        log(f"widedeep-remote: server pid {srv.pid} ready at {ep} "
            f"{r['server_ready_s']:.1f} s after its start (its "
            f"{PS_V:,} x {PS_E + 1} adagrad table drawn meanwhile)")
        client = PsClient([ep])
        emb = ps.DistributedEmbedding(
            PS_V, PS_E + 1, mode="async",
            table=RemoteEmbeddingTable(client, "emb", PS_E + 1),
            device="cuda")
        model = WideDeepHost(PS_E, PS_FIELDS, PS_DENSE, device="cuda")
        step = ps.PSTrainStep(model, _bce, Adam(learning_rate=1e-3), emb)
        rng = np.random.default_rng(0)
        ids = (rng.zipf(1.3, size=(PS_B, PS_FIELDS)) % PS_V).astype(np.int64)
        x = torch.as_tensor(rng.standard_normal((PS_B, PS_DENSE)).astype(
            np.float32), device="cuda")
        y = torch.as_tensor(rng.integers(0, 2, size=(PS_B, 1)).astype(
            np.float32), device="cuda")
        first = float(step(ids, x, y))

        def piped():
            step.prefetch(ids)
            return step(ids, x, y)
        step.flush()
        snap0 = client.transport_stats()
        step.prefetch(ids)
        ms, last = _timed_steps(piped, ())
        step.flush()
        snap1 = client.transport_stats()
        uniq = len(np.unique(ids))
        cap = max(256, 1 << int(np.ceil(np.log2(uniq))))
        analytic_f32_mb = cap * (8 + 2 * (PS_E + 1) * 4 + 8) / 1e6
        wire_mb = ((snap1["bytes_sent"] - snap0["bytes_sent"])
                   + (snap1["bytes_recv"] - snap0["bytes_recv"])) / (
                       PS_WARM + PS_ITERS) / 1e6
        step.prefetch(ids)
        busy, _ = device_busy_ms(piped)
        step.flush()
        apps = _compute_apps()
        r.update({
            "remote_examples_per_s": PS_B / ms * 1e3, "remote_step_ms": ms,
            "remote_vs_unpipelined": PS_B / ms * 1e3 / ps_row[
                "unpipelined_examples_per_s"],
            "remote_vs_prefetched": PS_B / ms * 1e3 / ps_row[
                "prefetched_examples_per_s"],
            "first_loss": first, "last_loss": last,
            "wire_mb_per_step": wire_mb, "analytic_f32_mb": analytic_f32_mb,
            "wire_vs_analytic_f32": wire_mb / analytic_f32_mb,
            "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / ms),
            "rpc_latency_ms": {op: v for op, v in snap1["latency_ms"].items()
                               if op in ("pull", "push", "push_pull")},
            "compute_apps_before": apps_before, "compute_apps": apps,
            "server_on_card": len(apps) != len(apps_before)
            or any(a[0] == str(srv.pid) for a in apps)})
        log(f"widedeep-remote: widedeep_ps_remote_examples_per_sec "
            f"{r['remote_examples_per_s']:.1f} ({ms:.3f} ms a step, host "
            f"clock over {PS_ITERS} after {PS_WARM} warm-ups, a prefetch "
            f"before every step), {r['remote_vs_unpipelined']:.3f} of phase "
            f"53's unpipelined and {r['remote_vs_prefetched']:.3f} of its "
            f"prefetched; loss {first:.5f} -> {last:.5f} [{power}]")
        log(f"widedeep-remote: widedeep_ps_remote_wire_mb_per_step "
            f"{wire_mb:.4f} measured on the bf16 wire, "
            f"{r['wire_vs_analytic_f32']:.3f} of bench.py's analytic f32 "
            f"{analytic_f32_mb:.4f} ({uniq} unique ids padded to {cap}) "
            f"[{power}]")
        log(f"widedeep-remote: device busy {busy:.3f} ms a step, idle share "
            f"{r['idle_share']:.3f}; RPC latency ms {r['rpc_latency_ms']} "
            f"[{power}]")
        log(f"widedeep-remote: the card's compute apps (pid, memory) "
            f"{apps}, before the server started {apps_before}: the server "
            f"(pid {srv.pid} here) holds a context: {r['server_on_card']} "
            f"[{power}]")

        def dry_small():
            from paddle_tpu_torch.framework import autopilot
            held = {}

            def tick(st):
                if "ctl" not in held:
                    held["ctl"] = autopilot.Controller(
                        step=st, dry_run=True, interval_steps=1,
                        hysteresis=1, cooldown_s=0.0, max_prefetch_depth=4,
                        blame_source=lambda: {"per_step_ms": {
                            "ps_wait": 30.0, "compute": 10.0}})
                held["ctl"].tick()
            got = remote_small(True, after_step=tick)
            return same(got, clean[True]), held["ctl"].decisions
        r["autopilot"] = autopilot_leg(step, ids, x, y, dry_small, power)
        client.bye()
        r["server_exit"] = srv.wait(timeout=120)
        del step, emb, model
        if not (math.isfinite(first) and last < first):
            fail(f"widedeep-remote: the loss did not fall ({first} -> "
                 f"{last})")
        if r["server_on_card"] or r["server_exit"] != 0:
            fail("widedeep-remote: the server touched the card or did not "
                 "exit after the bye")
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait(timeout=60)
        err.close()
    return r


def _clique_samples(steps):
    """Two 8-node cliques (tests/test_graph_service.py's graph): their
    features, labels and ``steps`` draws of 4 neighbours a node as
    (neighbour features with the missing ones 0, max(count, 1))."""
    import numpy as np
    from paddle_tpu_torch.distributed.ps.graph import GraphTable
    rng = np.random.default_rng(0)
    g = GraphTable()
    for base in (0, 8):
        for i in range(8):
            for j in range(i + 1, 8):
                g.add_edges([base + i], [base + j], bidirectional=True)
    feats = rng.standard_normal((16, 6)).astype(np.float32)
    feats[:8] += 1.5
    feats[8:] -= 1.5
    g.set_node_feat(np.arange(16), feats)
    draws = []
    for _ in range(steps):
        nbrs, counts = g.sample_neighbors(np.arange(16), 4)
        flat = nbrs.reshape(-1)
        valid = flat >= 0
        nf = g.get_node_feat(np.where(valid, flat, 0))
        nf[~valid] = 0.0
        draws.append((nf, np.maximum(counts, 1).astype(np.float32)[:, None]))
    return feats, np.array([0] * 8 + [1] * 8, np.int64), draws


def _sage_step(lin, opt, root_f, nbr_f, denom, labels, seg, n):
    """One GraphSAGE-mean step: the neighbours' mean by segment_sum, the
    root's features beside it, a linear classifier, cross-entropy, Adam."""
    import torch
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.nn import functional as TF
    agg = tpt.segment_sum(nbr_f, seg, num_segments=n) / denom
    loss = TF.cross_entropy(lin(torch.cat([root_f, agg], 1)), labels).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def graph_phase(power):
    """Phase 58: the graph table at ogbn-arxiv's published size (169,343
    nodes, 1,166,243 edges added both ways, 128 f32 features, 40 classes),
    drawn from the seed, sharded id % 2 over two PsServers on 127.0.0.1
    and read through RemoteGraphTable: one-hop sampling at fanout 25
    (GraphSAGE's S1) for batches of 1,024 roots, the neighbours' mean by
    segment_sum on the card, Linear(256, 40), Adam, 20 steps with finite,
    falling losses: roots/s, host ms of sampling and of the feature pull,
    device busy ms and idle share.  At the reference test's size (two
    8-node cliques) the card and the CPU run the same samples within
    TOL_PS_F32."""
    import copy

    import numpy as np
    import torch
    from paddle_tpu_torch.distributed.ps.graph import (GraphTable,
                                                       RemoteGraphTable)
    from paddle_tpu_torch.distributed.ps.service import PsClient, PsServer
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import Adam
    r = {}
    # card against CPU on the same samples, small
    feats, labels, draws = _clique_samples(25)
    torch.manual_seed(0)
    lin_c = Linear(12, 2, device="cpu")
    lin_g = copy.deepcopy(lin_c).to("cuda")
    seg16 = np.repeat(np.arange(16), 4)
    got = {}
    for key, dev, lin in (("cpu", "cpu", lin_c), ("card", "cuda", lin_g)):
        opt = Adam(learning_rate=0.1, parameters=lin.parameters())
        to = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
        got[key] = [float(_sage_step(lin, opt, to(feats), to(nf), to(dn),
                                     to(labels), to(seg16), 16))
                    for nf, dn in draws]
    err = _rel_err(got["card"], got["cpu"])
    r["small_card_vs_cpu_err"] = err
    log(f"graph at two 8-node cliques: 25 GraphSAGE steps on the same "
        f"samples, card vs CPU losses {err:.3g} (limit {TOL_PS_F32}); "
        f"losses {got['card'][0]:.5f} -> {got['card'][-1]:.5f} [{power}]")
    if err > TOL_PS_F32 or not got["card"][-1] < got["card"][0] * 0.2:
        fail("graph: the card disagrees with the CPU at the cliques, or "
             "they did not separate")

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    src = rng.integers(0, GRAPH_N, GRAPH_E)
    dst = rng.integers(0, GRAPH_N, GRAPH_E)
    feat = rng.standard_normal((GRAPH_N, GRAPH_D)).astype(np.float32)
    w_true = rng.standard_normal((GRAPH_D, GRAPH_C)).astype(np.float32)
    label = (feat @ w_true).argmax(1).astype(np.int64)
    a, b = np.concatenate([src, dst]), np.concatenate([dst, src])
    servers = []
    for s in range(2):
        g = GraphTable(embedding_dim=GRAPH_D, seed=s)
        keep = a % 2 == s
        g.add_edges(a[keep], b[keep])
        own = np.arange(s, GRAPH_N, 2)
        g.set_node_feat(own, feat[own])
        servers.append(PsServer({"g": g}).start())
    r["build_s"] = time.perf_counter() - t0
    log(f"graph: {GRAPH_N:,} nodes, {GRAPH_E:,} edges both ways, "
        f"{GRAPH_D}-wide features, {GRAPH_C} classes, sharded id % 2 over "
        f"two PsServers, built in {r['build_s']:.2f} s")
    client = PsClient([f"127.0.0.1:{s.port}" for s in servers])
    try:
        rg = RemoteGraphTable(client, "g")
        torch.manual_seed(0)
        lin = Linear(2 * GRAPH_D, GRAPH_C, device="cuda")
        opt = Adam(learning_rate=0.01, parameters=lin.parameters())
        seg = torch.arange(GRAPH_ROOTS, device="cuda").repeat_interleave(
            GRAPH_FANOUT)
        label_d = torch.as_tensor(label, device="cuda")
        host = {"sample_ms": [], "pull_ms": []}

        def one(roots):
            t0 = time.perf_counter()
            nbrs, counts = rg.sample_neighbors(roots, GRAPH_FANOUT)
            t1 = time.perf_counter()
            flat = nbrs.reshape(-1)
            valid = flat >= 0
            f = rg.get_node_feat(np.concatenate(
                [roots, np.where(valid, flat, 0)]))
            t2 = time.perf_counter()
            host["sample_ms"].append((t1 - t0) * 1e3)
            host["pull_ms"].append((t2 - t1) * 1e3)
            nf = f[GRAPH_ROOTS:]
            nf[~valid] = 0.0
            return _sage_step(
                lin, opt, torch.as_tensor(f[:GRAPH_ROOTS], device="cuda"),
                torch.as_tensor(nf, device="cuda"),
                torch.as_tensor(np.maximum(counts, 1).astype(
                    np.float32)[:, None], device="cuda"),
                label_d[torch.as_tensor(roots, device="cuda")], seg,
                GRAPH_ROOTS)

        batches = [rng.choice(GRAPH_N, GRAPH_ROOTS, replace=False)
                   for _ in range(GRAPH_STEPS + 1)]
        float(one(batches[-1]))               # warm
        host = {"sample_ms": [], "pull_ms": []}
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for roots in batches[:GRAPH_STEPS]:
            losses.append(one(roots))
        losses = [float(v) for v in losses]
        dt = time.perf_counter() - t0
        step_ms = dt * 1e3 / GRAPH_STEPS
        busy, _ = device_busy_ms(lambda: one(batches[0]))
        r.update({
            "roots_per_s": GRAPH_ROOTS * GRAPH_STEPS / dt,
            "step_ms": step_ms,
            "sample_host_ms": float(np.mean(host["sample_ms"][:GRAPH_STEPS])),
            "feature_pull_host_ms": float(np.mean(
                host["pull_ms"][:GRAPH_STEPS])),
            "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / step_ms),
            "losses": losses})
        log(f"graph: {r['roots_per_s']:.1f} roots/s ({step_ms:.3f} ms a step "
            f"of {GRAPH_ROOTS} roots at fanout {GRAPH_FANOUT}, host clock "
            f"over {GRAPH_STEPS} steps) [{power}]")
        log(f"graph: host ms a step of the sampling "
            f"{r['sample_host_ms']:.3f} and of the feature pull "
            f"{r['feature_pull_host_ms']:.3f}; device busy {busy:.3f} ms, "
            f"idle share {r['idle_share']:.3f} [{power}]")
        log(f"graph: losses {losses} [{power}]")
        client.bye()
    finally:
        for s in servers:
            s.shutdown()
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        fail(f"graph: the losses are not finite and falling: {losses}")
    return r


FILEFED_B = 128                # resnet50-filefed: bench.py's batch
FILEFED_HW = 224               # resnet50-filefed: crop size
FILEFED_IMAGES = 768           # resnet50-filefed: JPEGs of FILEFED_HW + 32
FILEFED_CLASSES = 10           # resnet50-filefed: class folders


def filefed_pil_loader(path):
    """bench.py's ``_pil_loader``: module-level, so a spawned DataLoader
    worker unpickles the DatasetFolder that references it."""
    import numpy as np
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def filefed_batch_collate(batch):
    """``filefed_collate`` over a list of (image, label) samples: the
    DataLoader's collate_fn, module-level for a spawned worker."""
    return filefed_collate([s[0] for s in batch], [s[1] for s in batch])


def filefed_images(root, n_images, size, classes):
    """bench.py's ``_gen_image_dataset``: a folder a class of JPEGs drawn
    from default_rng(7), quality 85; returns their bytes."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(7)
    for c in range(classes):
        os.makedirs(os.path.join(root, f"class_{c:02d}"), exist_ok=True)
    for i in range(n_images):
        arr = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
        Image.fromarray(arr).save(
            os.path.join(root, f"class_{i % classes:02d}", f"{i:05d}.jpg"),
            quality=85)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs)


def filefed_dataset(root, seed):
    """The JPEG folder with bench.py's augmentation, its draws from
    random.Random(seed)."""
    import random

    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.datasets import DatasetFolder
    g = random.Random(seed)
    aug = T.Compose([T.RandomResizedCrop(FILEFED_HW, generator=g),
                     T.RandomHorizontalFlip(generator=g)])
    return DatasetFolder(root, loader=filefed_pil_loader,
                         extensions=(".jpg",), transform=aug)


def filefed_loader(ds, seed, **kw):
    """A shuffled DataLoader (order from ``seed``), B = FILEFED_B,
    drop_last, bench.py's collate."""
    from paddle_tpu_torch import io
    sampler = io.BatchSampler(sampler=io.RandomSampler(ds, generator=seed),
                              batch_size=FILEFED_B, drop_last=True)
    return io.DataLoader(ds, batch_sampler=sampler,
                         collate_fn=filefed_batch_collate, **kw)


class KeepHost:
    """A loader whose host batches are kept as they are handed on."""

    def __init__(self, loader):
        self.loader, self.host = loader, []

    def __iter__(self):
        for b in self.loader:
            self.host.append(b)
            yield b


def _host_stream(loader):
    return [(x.copy(), y.copy()) for x, y in loader]


def _card_equal(card, host, what):
    """Every (x, y) on the card bitwise the host batch."""
    import numpy as np
    import torch
    if len(card) != len(host):
        fail(f"{what}: {len(card)} batches, the sequential loader "
             f"{len(host)}")
    for i, ((x, y), (hx, hy)) in enumerate(zip(card, host)):
        if x.dtype != torch.float32 or y.dtype != torch.int64 or \
                not np.array_equal(x.cpu().numpy(), hx) or \
                not np.array_equal(y.cpu().numpy(), hy):
            fail(f"{what}: batch {i} on the card is not the host batch "
                 "bitwise")


def resnet50_filefed_phase(power, dev="cuda"):
    """Phase 59: bench.py's bench_resnet50_filefed through the port: 768
    JPEGs of 256x256, DatasetFolder with RandomResizedCrop(224) and
    RandomHorizontalFlip (draws from a seeded random.Random), B = 128,
    bench.py's collate, its four legs each timed (pipelined drain with no
    cache; one process worker collating in the worker, timed from its
    first batch; the cached epoch, recorded by the sequential pass;
    cached-epoch O2 bf16 ResNet-50 training with Momentum(0.1, 0.9)).  The pipelined and worker streams are held
    bitwise to the sequential loader's, every training batch on the card
    to the host array it came from; the worker is absent from the card's
    compute apps; the losses are finite and every parameter moves."""
    import shutil as _sh
    import tempfile

    import numpy as np
    import torch
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.io import IngestPipeline
    from paddle_tpu_torch.io.pipeline import CachedDataset, SampleCache
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    root = tempfile.mkdtemp(prefix="filefed_images_")
    r = {}
    try:
        t0 = time.perf_counter()
        jpeg_bytes = filefed_images(root, FILEFED_IMAGES, FILEFED_HW + 32,
                                    FILEFED_CLASSES)
        r["write_s"] = time.perf_counter() - t0
        r["jpeg_bytes"] = jpeg_bytes
        # the sequential stream, which also records the decoded-sample
        # cache (epoch 1 of leg 3)
        cache = SampleCache(mode="memory", max_bytes=2 << 30)
        cds = CachedDataset(filefed_dataset(root, 1), cache)
        t0 = time.perf_counter()
        want = _host_stream(filefed_loader(cds, 0))
        r["sequential_examples_per_s"] = FILEFED_IMAGES / (
            time.perf_counter() - t0)

        def drain(pipe, from_first=False, probe=None):
            out, n, t0 = [], 0, time.perf_counter()
            for xb, yb in pipe:
                if from_first and not out:
                    if probe is not None:
                        probe()
                    t0 = time.perf_counter()
                out.append((xb, yb))
                n += int(xb.shape[0])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            return out, (n - FILEFED_B if from_first else n) / dt, dt

        # 1) pipelined ingest drain, cache off
        got, rate, dt = drain(IngestPipeline(
            filefed_loader(filefed_dataset(root, 1), 0), device=dev))
        _card_equal(got, want, "resnet50-filefed pipelined stream")
        r["ingest_examples_per_s"] = rate
        r["ingest_mb_per_s"] = jpeg_bytes / dt / 1e6
        del got

        # 2) one process worker, collate in the worker
        apps_before = _compute_apps()
        seen = {}
        wl = filefed_loader(filefed_dataset(root, 1), 0, num_workers=1,
                            use_process_workers=True, collate_in_worker=True)
        got, rate_w, _ = drain(
            IngestPipeline(wl, device=dev), from_first=True,
            probe=lambda: seen.setdefault("apps", _compute_apps()))
        _card_equal(got, want, "resnet50-filefed worker stream")
        del got
        if len(seen["apps"]) != len(apps_before):
            fail(f"resnet50-filefed: the card's compute apps went from "
                 f"{apps_before} to {seen['apps']} with the DataLoader "
                 "worker running: the worker holds a CUDA context")
        r["worker_examples_per_s"] = rate_w
        r["worker_vs_pipelined"] = rate_w / rate
        r["worker_stage_ms"] = {k: v for k, v in wl.last_stage_ms.items()
                                if k.endswith("_ms")}
        r["compute_apps"] = [len(apps_before), len(seen["apps"])]

        # 3) the decoded-sample cache: the sequential pass recorded epoch
        # 1, this epoch hits
        _, rate_c, _ = drain(IngestPipeline(filefed_loader(cds, 1),
                                            device=dev))
        if cache.hits != FILEFED_IMAGES or cache.misses != FILEFED_IMAGES:
            fail(f"resnet50-filefed: cache hits {cache.hits}, misses "
                 f"{cache.misses}, want {FILEFED_IMAGES} each")
        r["cached_examples_per_s"] = rate_c
        r["cache_vs_pipelined"] = rate_c / rate
        r["cache_bytes"] = cache.bytes_used

        # 4) cached-epoch training
        model = resnet50(num_classes=1000)
        step = TrainStep(model, lambda m, x, y: vision_loss_of(m(x), y),
                         Momentum(learning_rate=0.1, momentum=0.9),
                         amp_level="O2", amp_dtype="bfloat16")
        for xb, yb in IngestPipeline(filefed_loader(cds, 2), device=dev):
            float(step(xb, yb))             # warm: one batch
            break
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        monitor.reset_all_histograms()
        keep = KeepHost(filefed_loader(cds, 3))
        pipe = IngestPipeline(keep, device=dev)
        losses, used, n = [], [], 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for xb, yb in pipe:
            losses.append(step(xb, yb))
            used.append((xb, yb))
            n += int(xb.shape[0])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _card_equal(used, keep.host, "resnet50-filefed training batches")
        losses = [float(v) for v in losses]
        if not all(np.isfinite(losses)):
            fail(f"resnet50-filefed: non-finite losses {losses}")
        still = [k for k, p in model.named_parameters()
                 if torch.equal(p.detach(), p0[k])]
        if still:
            fail(f"resnet50-filefed: {len(still)} parameters did not move, "
                 f"e.g. {still[:3]}")
        r["train_samples_per_s"] = n / dt
        r["train_step_ms"] = dt / len(losses) * 1e3
        r["input_stall_pct"] = pipe.input_stall_pct
        hists = monitor.all_histograms()
        r["train_ingest_mean_ms"] = {
            k: hists[k]["mean"] for k in ("ingest_decode_ms",
                                          "ingest_transfer_ms",
                                          "ingest_wait_ms") if k in hists}
        r["losses"] = losses
    finally:
        _sh.rmtree(root, ignore_errors=True)
    r["power"] = power
    log("resnet50-filefed: " + json.dumps(r))
    return r


DURABLE_KEEP = 2               # gpt-durable: generations the manager keeps
DURABLE_LAYERS = 8             # gpt-durable: GPT-2 345M's width at this depth
DURABLE_ZERO_LAYERS = 4        # gpt-durable: ZeRO interop at 345M's width
DURABLE_NUMERICS_STEPS = 3     # gpt-durable: armed numerics steps
TOL_NUMERICS = 1e-5            # gpt-durable: norms against the f64 recompute
NUMERICS_BAD_LEAF = "lnf_b"    # gpt-durable: the leaf whose gradient is NaN


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _params_host(model):
    return {n: p.detach().cpu().clone() for n, p in model.named_parameters()}


def _serialized_stamps(step, generation):
    """{file: (crc32, bytes)} a sync save of ``step`` at ``generation``
    would write, from the same serialization, without writing."""
    import zlib

    import torch
    from paddle_tpu_torch.distributed import checkpoint as ck
    state, _ = ck._capture_train_state(step, generation, None)
    leaves = []
    ck._leafify(state, leaves, "")
    out = {}
    for i, (_, arr) in enumerate(leaves):
        if isinstance(arr, torch.Tensor):
            fname = ck._shard_fname(i, (slice(None),) * arr.dim())
        else:
            fname = f"leaf{i}.full.npy"
        head, body = ck._npy_parts(arr)
        out[fname] = (zlib.crc32(body, zlib.crc32(head)) & 0xFFFFFFFF,
                      len(head) + body.nbytes)
    return out


def _stamps_on_disk(path):
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    return {sh["file"]: (sh["crc32"], sh["bytes"])
            for rec in meta["leaves"] for sh in rec["shards"]}


def gpt_durable_phase(cfg, fa, power, dev="cuda"):
    """Phase 60: bench_gpt2_345m's step (GPT-2 345M's width at
    cfg.num_layers, DURABLE_LAYERS in main; B = 8, S = 1024, remat=False,
    O2 bf16, AdamW(1e-4), on #1-#3) saved and restored
    through the durable-state plane: 2 steps, a sync generation, 1 step,
    an async generation while one more step runs; the async files are a
    sync save of the same snapshot (their crc32 and byte stamps against
    the serialization of that moment) and verify deeply; a fresh step
    restored from it takes the next 2 steps bitwise the uninterrupted
    run's; a flipped byte in the newest generation walks the restore back
    one generation (ckpt_fallback_total); ZeRO at world size 1
    (DURABLE_ZERO_LAYERS layers at 345M's width) saved and loaded into a
    replicated TrainStep steps on bitwise alike; numerics armed for 3 steps holds the global grad, param and
    update norms within TOL_NUMERICS of an f64 recompute from the same
    gradients, a NaN planted in lnf_b's gradient is named by
    first_bad_leaf, and the synchronisations of a step are counted armed
    and disarmed.  Save and load GB/s, bytes on disk and free space are
    printed; the directory is removed at the end."""
    import shutil as _sh
    import tempfile

    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.distributed.durable import CheckpointManager
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep, loss_and_grads
    from paddle_tpu_torch.models import GPT, GPTConfig, gpt_loss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import LoopbackWorld
    from paddle_tpu_torch.parallel.zero import ShardedUpdateTrainStep
    rng = np.random.default_rng(60)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S), dtype=np.int64)).to(dev)
        for _ in range(6)]

    def make_step():
        return TrainStep(GPT(cfg, device=dev), gpt_loss,
                         AdamW(learning_rate=1e-4), amp_level="O2",
                         amp_dtype="bfloat16")

    def run(step, ids):
        return step(ids, ids)

    root = tempfile.mkdtemp(prefix="gpt_durable_")
    r = {"free_bytes_at_start": _sh.disk_usage(root).free}
    reset_fa(fa)
    planes_reset()
    try:
        part = time.perf_counter()
        step = make_step()
        mgr = CheckpointManager(root, keep_last=DURABLE_KEEP)
        for ids in batches[:2]:
            run(step, ids)
        torch.cuda.synchronize()
        r["build_and_2_steps_s"] = time.perf_counter() - part
        t0 = time.perf_counter()
        mgr.save(step, 1)
        r["save_sync_s"] = time.perf_counter() - t0
        r["generation_bytes"] = _dir_bytes(mgr.generation_dir(1))
        r["save_sync_gbps"] = r["generation_bytes"] / r["save_sync_s"] / 1e9
        run(step, batches[2])
        torch.cuda.synchronize()
        part = time.perf_counter()
        want = _serialized_stamps(step, 2)
        r["stamps_s"] = time.perf_counter() - part
        t0 = time.perf_counter()
        handle = mgr.save(step, 2, mode="async")
        r["save_async_call_s"] = time.perf_counter() - t0
        cont = [run(step, batches[3])]       # while the async save writes
        handle.wait()
        ck.wait_pending_saves()
        r["save_async_total_s"] = time.perf_counter() - t0
        got = _stamps_on_disk(mgr.generation_dir(2))
        if got != want:
            bad = sorted(k for k in set(got) | set(want)
                         if got.get(k) != want.get(k))
            fail(f"gpt-durable: the async generation is not the sync save "
                 f"of its snapshot: {bad[:4]}")
        problems = ck.verify_checkpoint(mgr.generation_dir(2), deep=True)
        if problems or not ck.is_committed(mgr.generation_dir(2)):
            fail(f"gpt-durable: generation 2 does not verify: {problems[:3]}")
        cont.append(run(step, batches[4]))
        cont = [float(v) for v in cont]
        final = _params_host(step.model)
        r["bytes_on_disk"] = _dir_bytes(root)
        r["free_bytes_with_generations"] = _sh.disk_usage(root).free
        r["generations"] = mgr.generations()

        fresh = make_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mgr.restore(fresh, deep=False) != 2:
            fail("gpt-durable: the restore did not take generation 2")
        torch.cuda.synchronize()
        r["load_s"] = time.perf_counter() - t0
        r["load_gbps"] = r["generation_bytes"] / r["load_s"] / 1e9
        resumed = [float(run(fresh, ids)) for ids in batches[3:5]]
        if resumed != cont:
            fail(f"gpt-durable: resumed losses {resumed}, the uninterrupted "
                 f"run's {cont}")
        moved = [n for n, p in fresh.model.named_parameters()
                 if not torch.equal(p.detach().cpu(), final[n])]
        if moved:
            fail(f"gpt-durable: resumed parameters differ from the "
                 f"uninterrupted run's: {moved[:4]}")
        r["resumed_losses"] = resumed

        shard = sorted(f for f in os.listdir(mgr.generation_dir(2))
                       if f.endswith(".npy"))[0]
        path = os.path.join(mgr.generation_dir(2), shard)
        with open(path, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            byte = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0xFF]))
        before = monitor.get_stat("ckpt_fallback_total")
        part = time.perf_counter()
        if mgr.restore(fresh) != 1:
            fail("gpt-durable: a flipped byte in generation 2 did not walk "
                 "the restore back to generation 1")
        r["walk_back_s"] = time.perf_counter() - part
        r["fallbacks_counted"] = monitor.get_stat("ckpt_fallback_total") \
            - before
        if r["fallbacks_counted"] != 1:
            fail(f"gpt-durable: ckpt_fallback_total rose by "
                 f"{r['fallbacks_counted']}, want 1")
        del fresh
        _sh.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        torch.cuda.empty_cache()

        # ZeRO at world size 1 into a replicated TrainStep
        part = time.perf_counter()
        zdir = os.path.join(root, "zero")

        zcfg = GPTConfig(hidden_size=cfg.hidden_size,
                         num_heads=cfg.num_heads, vocab_size=cfg.vocab_size,
                         max_seq_len=cfg.max_seq_len,
                         num_layers=DURABLE_ZERO_LAYERS, remat=False)

        def zero_rank(rank, mesh):
            z = ShardedUpdateTrainStep(
                GPT(zcfg, device=dev), gpt_loss, AdamW(learning_rate=1e-4),
                mesh=mesh, wire_dtype="f32", amp_level="O2",
                amp_dtype="bfloat16")
            z(batches[0], batches[0])
            ck.save_train_state(z, zdir, commit=True)
            loss = float(z(batches[1], batches[1]))
            return z, loss
        z, z_loss = LoopbackWorld(1).run(zero_rank)[0]
        rep = TrainStep(GPT(zcfg, device=dev), gpt_loss,
                        AdamW(learning_rate=1e-4), amp_level="O2",
                        amp_dtype="bfloat16")
        ck.load_train_state(rep, zdir)
        rep_loss = float(run(rep, batches[1]))
        if rep_loss != z_loss:
            fail(f"gpt-durable: the replicated step from the ZeRO "
                 f"checkpoint took loss {rep_loss}, ZeRO {z_loss}")
        diff = [n for (n, p), q in zip(rep.model.named_parameters(),
                                       z.model.parameters())
                if not torch.equal(p.detach(), q.detach())]
        if diff:
            fail(f"gpt-durable: replicated and ZeRO parameters differ after "
                 f"the step from the checkpoint: {diff[:4]}")
        r["zero_interop_loss"] = z_loss
        r["zero_interop_s"] = time.perf_counter() - part
        del z, rep
        torch.cuda.empty_cache()

        # numerics, armed and disarmed
        part = time.perf_counter()
        syncs_off, _ = count_syncs(lambda: run(step, batches[5]))
        set_flags({"numerics": True})
        try:
            rows = []
            for k in range(DURABLE_NUMERICS_STEPS):
                ids = batches[k]
                params = step._params()
                before_p = {n: p.detach().clone() for n, p in params.items()}
                _, grads = loss_and_grads(step._loss_from, params, [ids, ids])
                f64 = {
                    "grad_norm": math.sqrt(sum(float((g.double() ** 2).sum())
                                               for g in grads.values())),
                    "param_norm": math.sqrt(sum(float((p.double() ** 2).sum())
                                                for p in before_p.values()))}
                del grads
                if k == DURABLE_NUMERICS_STEPS - 1:
                    syncs_on, _ = count_syncs(lambda: run(step, ids))
                else:
                    run(step, ids)
                rec = step.last_numerics
                f64["update_norm"] = math.sqrt(sum(
                    float(((p.detach().double() - before_p[n].double()) ** 2)
                          .sum()) for n, p in params.items()))
                del before_p
                errs = {k2: abs(getattr(rec, k2) - v) / v
                        for k2, v in f64.items()}
                rows.append(errs)
                if max(errs.values()) > TOL_NUMERICS or not rec.finite():
                    fail(f"gpt-durable: numerics step {k}: relative errors "
                         f"{errs} against the f64 recompute, finite "
                         f"{rec.finite()}")
            r["numerics_rel_err"] = rows
            r["numerics_grad_norm"] = rec.grad_norm
            r["syncs_per_step"] = {"disarmed": syncs_off, "armed": syncs_on}
            if syncs_on != syncs_off + 1:
                fail(f"gpt-durable: armed numerics synchronised {syncs_on} "
                     f"times a step, disarmed {syncs_off}: the packed aux "
                     "must be its one read")
            hook = dict(step.model.named_parameters())[
                NUMERICS_BAD_LEAF].register_hook(
                    lambda g: torch.full_like(g, float("nan")))
            try:
                run(step, batches[0])
            finally:
                hook.remove()
            bad = step.last_numerics
            r["numerics_first_bad_leaf"] = bad.first_bad_leaf()
            if bad.first_bad_leaf() != NUMERICS_BAD_LEAF or bad.finite():
                fail(f"gpt-durable: a NaN in {NUMERICS_BAD_LEAF}'s gradient "
                     f"was named {bad.first_bad_leaf()!r}")
        finally:
            set_flags({"numerics": False})
        r["numerics_s"] = time.perf_counter() - part
        del step
        torch.cuda.empty_cache()
    finally:
        _sh.rmtree(root, ignore_errors=True)
    launches = _flash_launches(fa)
    if min(launches.values()) == 0:
        fail(f"gpt-durable: a flash kernel was not launched: {launches}")
    r["launches"] = launches
    r["power"] = power
    log("gpt-durable: " + json.dumps(r))
    return r, launches


# -- the operations planes (phases 61-63) ------------------------------------
RESILIENT_CALLS = 6            # resilient-gpt: wrapped calls, one poisoned
RESILIENT_POISON = 3           # resilient-gpt: the poisoned call (1-based)
RESILIENT_RING = 2             # resilient-gpt: FLAGS_incident_ring on the card
RESILIENT_SEED = 61            # resilient-gpt: its batches
# resilient-gpt: its weights, phase 3's draw (kept by draw_once)
RESILIENT_WEIGHTS_SEED = 0
RESILIENT_STATE_CAP_MB = 64.0  # resilient-gpt: FLAGS_incident_state_cap_mb
PARITY_LAYERS = 2              # parity-numerics: GPT-2 345M's width, 2 layers
PARITY_STEPS = 3               # parity-numerics: armed steps a run
PARITY_FLIP_LEAF = "lnf_b"     # parity-numerics: the leaf whose bit flips
ELASTIC_LAYERS = 4             # ops-planes: the elastic worker's GPT depth
ELASTIC_STEPS = 4              # ops-planes: the worker's steps
# ops-planes: the agent's progress deadline (s); a beat waits for the
# worker's sync generation (1.2 GB, ~3.4 s at the 0.36 GB/s gpt-durable reads)
ELASTIC_DEADLINE = 10.0
AUTOPILOT_INTERVAL = 3         # widedeep-remote: steps an autopilot interval
AUTOPILOT_INTERVALS = 3        # widedeep-remote: intervals of the live leg


def resilient_loss(model, ids, labels, scale):
    """gpt_loss times the mean of ``scale`` (a float input of ones): the
    input ``train.step_grads`` poisons, so a NaN reaches the loss and
    every gradient through the real backward."""
    from paddle_tpu_torch.models import gpt_loss
    return gpt_loss(model, ids, labels) * scale.mean()


def _resilient_step(seed=RESILIENT_WEIGHTS_SEED):
    """bench_gpt2_345m's step (GPT-2 345M, remat=False, O2 bf16,
    AdamW(1e-4)) on resilient_loss, its weights drawn from ``seed``."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPT, gpt2_345m
    from paddle_tpu_torch.optimizer import AdamW
    cfg = gpt2_345m(max_seq_len=S, remat=False)
    cfg.seed = int(seed)
    return TrainStep(GPT(cfg, device="cuda"), resilient_loss,
                     AdamW(learning_rate=1e-4), amp_level="O2",
                     amp_dtype="bfloat16")


def resilient_program(seed=RESILIENT_WEIGHTS_SEED):
    """Phase 61's step in ResilientTrainStep(snapshot_every=1): the replay
    builder of its incident bundle (``chip_smoke:resilient_program``)."""
    from paddle_tpu_torch.framework import incident
    from paddle_tpu_torch.framework.resilient import ResilientTrainStep
    incident.set_program("chip_smoke:resilient_program", seed=int(seed))
    return ResilientTrainStep(_resilient_step(seed), snapshot_every=1)


def resilient_gpt_phase(fa, power, planes_row):
    """Phase 61: bench_gpt2_345m's step (GPT-2 345M, B = 8, S = 1024,
    remat=False, O2 bf16, AdamW(1e-4)) in
    ResilientTrainStep(snapshot_every=1) with attach_durable (generation
    1 after the first call), FLAGS_incident
    (a ring of RESILIENT_RING) and FLAGS_numerics armed, RESILIENT_CALLS
    calls with ``train.step_grads`` poisoning the loss scale at call
    RESILIENT_POISON: one skip and one restore; the good losses and the
    final parameters bitwise an unwrapped run fed the same batches
    without the poisoned one; first_bad_leaf named; the bundle verified,
    its state a reference to generation 1 (the state is above the cap);
    paddle_tpu_torch/tools/replay.py on the card reproduces first_bad_leaf
    and --bisect names the poisoned call's step.  The run feeds a run
    ledger record, the blame of the steps' spans and of the profiler's
    trace, and a MetricsReporter pushing to an in-process CollectorServer
    (the worker, its step statistics and the incident notice in its view;
    the reporter's Prometheus file is monitor.export_prometheus()).
    Readings: snapshot ms and GB/s, ms a call wrapped (armed and
    disarmed) and unwrapped, and the synchronisations of a call; the
    TrainStep call with the planes disarmed adds none to phase 55's."""
    import contextlib
    import io
    import shutil as _sh
    import tempfile

    import numpy as np
    import torch
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed.durable import CheckpointManager
    from paddle_tpu_torch.framework import (blame, chaos, incident, monitor,
                                            observability, runlog)
    from paddle_tpu_torch.framework.collector import CollectorServer
    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    from paddle_tpu_torch.models import gpt2_345m
    from paddle_tpu_torch.tools import replay
    r = {}
    rng = np.random.default_rng(RESILIENT_SEED)
    cfg = gpt2_345m(max_seq_len=S, remat=False)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S), dtype=np.int64)).to("cuda")
        for _ in range(RESILIENT_CALLS)]
    scale = torch.ones(1, device="cuda")
    root = tempfile.mkdtemp(prefix="resilient_gpt_")
    names = ["incident", "incident_ring", "incident_dir", "numerics",
             "runlog_dir", "incident_state_cap_mb", "replica_parity",
             "replica_parity_every", "incident_kinds"]
    saved = get_flags(names)
    tracer = observability.tracer
    reset_fa(fa)
    planes_reset()
    incident.reset()
    try:
        # the unwrapped run: the same batches without the poisoned one
        plain = _resilient_step()
        want, plain_ms = [], []
        for i, ids in enumerate(batches):
            if i == RESILIENT_POISON - 1:
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want.append(float(plain(ids, ids, scale)))
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        want_params = _params_host(plain.model)
        syncs_plain, _ = count_syncs(lambda: plain(batches[0], batches[0],
                                                   scale))
        del plain
        torch.cuda.empty_cache()
        per_step_55 = planes_row["syncs_unarmed"] / PLANES_SYNC_STEPS
        r["syncs_trainstep_disarmed"] = syncs_plain
        if syncs_plain != per_step_55:
            fail(f"resilient-gpt: a TrainStep call with the planes disarmed "
                 f"synchronised {syncs_plain} times, phase 55's {per_step_55}")

        # the wrapped run, every plane armed
        set_flags({"incident": True, "incident_ring": RESILIENT_RING,
                   "incident_dir": os.path.join(root, "incidents"),
                   "numerics": True, "incident_kinds": "",
                   "runlog_dir": os.path.join(root, "runlog"),
                   "incident_state_cap_mb": RESILIENT_STATE_CAP_MB,
                   "replica_parity": True,
                   "replica_parity_every": 1})
        tdir = os.path.join(root, "trace")
        tracer.enable(tdir, label="resilient")
        srv = CollectorServer().start()
        prom = os.path.join(root, "metrics.prom")
        reporter = observability.MetricsReporter(
            prom, interval=3600.0, collector=srv.endpoint,
            worker="resilient-gpt", role="trainer").start()
        res = resilient_program()
        mgr = CheckpointManager(os.path.join(root, "gens"), keep_last=8)
        res.attach_durable(mgr, every=0, arm_preemption=False)
        chaos.reset(0)
        chaos.arm("train.step_grads", mode="nan", nth=RESILIENT_POISON,
                  n_times=1, payload_index=2)
        got, skipped, call_ms = [], [], []
        prof_dir = os.path.join(root, "prof")
        profiling = False
        try:
            for i, ids in enumerate(batches):
                if i == RESILIENT_CALLS - 2:
                    profiler.start_profiler("All", trace_dir=prof_dir)
                    profiling = True
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = float(res(ids, ids, scale))
                call_ms.append((time.perf_counter() - t0) * 1e3)
                skipped.append(res.last_step_skipped)
                if not res.last_step_skipped:
                    got.append(loss)
                if i == 0:
                    t0 = time.perf_counter()
                    mgr.save(res.step, 1, mode="sync")
                    r["generation_save_s"] = time.perf_counter() - t0
        finally:
            if profiling:
                profiler.stop_profiler(
                    profile_path=os.path.join(root, "prof.txt"))
            chaos.reset(0)
            tracer.disable()
        bad_leaf = res.last_bad_leaf
        r["skipped"] = skipped
        r["first_bad_leaf"] = bad_leaf
        r["restores"] = monitor.get_stat("train_restores_total")
        log(f"resilient-gpt: {RESILIENT_CALLS} calls, call "
            f"{RESILIENT_POISON} poisoned: skipped {skipped}, restores "
            f"{r['restores']}, first_bad_leaf {bad_leaf!r}; losses {got} "
            f"against the unwrapped run's {want} [{power}]")
        if skipped != [i == RESILIENT_POISON - 1
                       for i in range(RESILIENT_CALLS)] or \
                res.skipped_steps != 1 or r["restores"] != 1:
            fail(f"resilient-gpt: skips {skipped}, restores {r['restores']}")
        if got != want:
            fail(f"resilient-gpt: the wrapped run's losses {got} are not the "
                 f"unwrapped run's {want}")
        moved = [n for n, p in res.step.model.named_parameters()
                 if not torch.equal(p.detach().cpu(), want_params[n])]
        if moved:
            fail(f"resilient-gpt: final parameters differ from the unwrapped "
                 f"run's: {moved[:4]}")
        if not bad_leaf:
            fail("resilient-gpt: the skipped step named no first_bad_leaf")

        # the snapshot's cost, and the calls' synchronisations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res.snapshot()
        snap_s = time.perf_counter() - t0
        r["snapshot_ms"] = snap_s * 1e3
        r["snapshot_bytes"] = res.snapshot_bytes()
        r["snapshot_gbps"] = r["snapshot_bytes"] / snap_s / 1e9
        r["call_ms_armed"] = call_ms
        r["step_ms_unwrapped"] = plain_ms
        syncs_armed, _ = count_syncs(lambda: res(batches[1], batches[1],
                                                 scale))
        set_flags({"incident": False, "numerics": False,
                   "replica_parity": False})
        syncs_wrapped, wrapped_ms = count_syncs(
            lambda: res(batches[1], batches[1], scale))
        r["call_ms_disarmed"] = wrapped_ms
        r["syncs_per_call"] = {"wrapped_armed": syncs_armed,
                               "wrapped_disarmed": syncs_wrapped,
                               "trainstep_disarmed": syncs_plain}
        log(f"resilient-gpt: snapshot of {r['snapshot_bytes']} bytes "
            f"(parameters, buffers, AdamW state) to pinned host buffers "
            f"{r['snapshot_ms']:.1f} ms, {r['snapshot_gbps']:.2f} GB/s; ms a "
            f"call wrapped with every plane armed "
            f"{[round(v, 1) for v in call_ms]}, wrapped disarmed "
            f"{wrapped_ms:.1f}, unwrapped "
            f"{[round(v, 1) for v in plain_ms]}; synchronisations a call "
            f"{r['syncs_per_call']} [{power}]")

        # the bundle, then the replay tool on the card
        bundle = incident.recorder.last_bundle
        problems = incident.verify_bundle(bundle) if bundle else ["none"]
        man = incident.read_manifest(bundle) if bundle else {}
        r["bundle_state"] = man.get("state")
        log(f"resilient-gpt: incident bundle {bundle}: problems {problems}, "
            f"event {man.get('event', {}).get('kind')}, state "
            f"{man.get('state')}, ring steps "
            f"{[e['step'] for e in man.get('ring', [])]}")
        if problems or man["state"].get("inline") or \
                (man["state"].get("ref") or {}).get("generation") != 1:
            fail(f"resilient-gpt: the bundle does not verify or its state is "
                 f"not a reference to generation 1: {problems} "
                 f"{man.get('state')}")
        verdicts = {}
        for args in ([bundle], [bundle, "--bisect"]):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = replay.main(args)
            line = out.getvalue().strip().splitlines()[-1]
            verdicts[args[-1] == "--bisect"] = (
                rc, line, time.perf_counter() - t0)
            chaos.reset(0)
            torch.cuda.empty_cache()
        r["replay"] = verdicts[False]
        r["bisect"] = verdicts[True]
        log(f"resilient-gpt: replay.py on the card: {verdicts[False]}; "
            f"--bisect: {verdicts[True]} [{power}]")
        if verdicts[False][0] != 0 or \
                f"first_bad_leaf={bad_leaf}" not in verdicts[False][1]:
            fail(f"resilient-gpt: the replay did not reproduce "
                 f"{bad_leaf!r}: {verdicts[False]}")
        if verdicts[True][0] != 0 or f"step={RESILIENT_POISON - 1} " not in \
                verdicts[True][1]:
            fail(f"resilient-gpt: --bisect did not name step "
                 f"{RESILIENT_POISON - 1}: {verdicts[True]}")

        # the ledger, blame and the collector
        res_blame = blame.compute_blame(blame.load_trace_dir(tdir))
        rec = runlog.capture("resilient_gpt", label="chip_smoke",
                             trace_dir=tdir, blame_result=res_blame)
        led = runlog.RunLedger(runlog.default_ledger_path())
        led.append(rec)
        kinds = [x["kind"] for x in led.read()]
        traces = [f for f in os.listdir(prof_dir)
                  if f.startswith("device_trace")]
        with open(os.path.join(prof_dir, traces[0])) as f:
            chrome = json.load(f)
        prof_blame = blame.compute_blame(blame.from_chrome_trace(chrome),
                                         step_span="TrainStep")
        r["blame_spans"] = {"n_steps": res_blame["n_steps"],
                            "per_step_ms": res_blame["per_step_ms"],
                            "top": res_blame["top_category"]}
        r["blame_profiler"] = {"n_steps": prof_blame["n_steps"],
                               "per_step_ms": prof_blame["per_step_ms"],
                               "top": prof_blame["top_category"]}
        reporter.stop()
        view = srv.view()
        srv.shutdown()
        worker = view["workers"].get("resilient-gpt") or {}
        notices = [n.get("id") for n in view.get("incidents", [])]
        # the reporter's own file write, the collector down and the push
        # thread stopped: nothing else moves the statistics meanwhile
        reporter._collector = None
        reporter.write_once()
        prom_same = open(prom).read() == monitor.export_prometheus()
        r["ledger_kinds"] = kinds
        r["collector"] = {"steps_total": worker.get("steps_total"),
                          "incidents": notices, "prometheus_same": prom_same}
        log(f"resilient-gpt: run ledger kinds {kinds}; blame of the span "
            f"file {r['blame_spans']}, of the profiler's trace (TrainStep "
            f"ranges) {r['blame_profiler']}; the collector's view: steps "
            f"{worker.get('steps_total')}, incidents {notices}; the "
            f"reporter's Prometheus file is monitor.export_prometheus(): "
            f"{prom_same} [{power}]")
        if "incident" not in kinds or "resilient_gpt" not in kinds:
            fail(f"resilient-gpt: the run ledger holds {kinds}")
        if res_blame["n_steps"] != RESILIENT_CALLS or \
                prof_blame["n_steps"] < 2:
            fail(f"resilient-gpt: blame found {res_blame['n_steps']} span "
                 f"steps and {prof_blame['n_steps']} profiler steps")
        if not worker.get("steps_total") or not notices or not prom_same:
            fail(f"resilient-gpt: the collector's view {worker} incidents "
                 f"{notices}, Prometheus file equal {prom_same}")
        del res
    finally:
        set_flags(saved)
        incident.uninstall()
        incident.reset()
        _sh.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    launches = _flash_launches(fa)
    if min(launches.values()) == 0:
        fail(f"resilient-gpt: a flash kernel was not launched: {launches}")
    r["launches"] = launches
    r["power"] = power
    log("resilient-gpt: " + json.dumps(r, default=str))
    return r, launches


def _f64_partials(grads, before, after, split):
    """Each leaf's f64 sums of squares (gradient, parameter before, update)
    of this rank's pieces, the leaves whole on every rank zeroed on ranks
    other than 0 (``split[n]`` false and ``lead`` false)."""
    out = {}
    for n in sorted(grads):
        move = after[n].detach().double() - before[n].double()
        out[n] = (float((grads[n].double() ** 2).sum()),
                  float((before[n].double() ** 2).sum()),
                  float((move ** 2).sum()), split[n])
    return out


def parity_numerics_phase(cfg, ids_t, fa, power):
    """Phase 62: at GPT-2 345M's width and PARITY_LAYERS layers on two
    LoopbackWorld ranks (threads) on the one card.  (a) dp = 2,
    ShardedUpdateTrainStep on the f32 wire with FLAGS_replica_parity armed
    every step for PARITY_STEPS steps: no divergence; each rank's device
    hash of every replicated leaf bitwise leaf_hash_host of its host copy;
    the probe's ms; one bit flipped in rank 1's copy of PARITY_FLIP_LEAF
    gives one parity.divergence naming it; disarmed, the losses are the
    armed run's bitwise and a step synchronises as often as with the hook
    taken out.  (b) ShardedTrainStep at mp = 2 with FLAGS_numerics armed:
    each step's record (grad, param and update norms) within TOL_NUMERICS
    of an f64 recompute from the same gradients and parameters and equal
    on both ranks, beside a planted record that leaves out the sum over
    mp.  Returns the readings and #1-#3's launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch.framework import monitor, numerics, observability
    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    from paddle_tpu_torch.jit import loss_and_grads
    from paddle_tpu_torch.models import GPT, GPTConfig, gpt_loss, \
        shard_params
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import (LoopbackWorld, ShardedTrainStep,
                                           parity, sharded)
    from paddle_tpu_torch.parallel.zero import ShardedUpdateTrainStep
    r = {}
    saved = get_flags(["replica_parity", "replica_parity_every",
                       "numerics"])
    cfg2 = GPTConfig(hidden_size=cfg.hidden_size, num_heads=cfg.num_heads,
                     vocab_size=cfg.vocab_size, max_seq_len=S,
                     num_layers=PARITY_LAYERS, remat=False)
    init = {n: p.detach().clone()
            for n, p in GPT(cfg2, device="cuda").named_parameters()}
    amp = {"amp_level": "O2", "amp_dtype": "bfloat16"}
    reset_fa(fa)
    planes_reset()

    def dp_run(armed, flip=False, hook=True, steps=PARITY_STEPS):
        set_flags({"replica_parity": armed, "replica_parity_every": 1})

        def fn(rank, mesh):
            m = GPT(cfg2, device="cuda")
            with torch.no_grad():
                for n, p in m.named_parameters():
                    p.copy_(init[n])
            step = ShardedUpdateTrainStep(m, gpt_loss,
                                          AdamW(learning_rate=1e-4),
                                          mesh=mesh, wire_dtype="f32", **amp)
            losses = [float(step(ids_t, ids_t)) for _ in range(steps)]
            out = {"losses": losses}
            if armed:
                tree = parity._state_tree(step, replicated_only=True)
                probe = step._parity_probe
                dev = probe.hashes(tree).cpu().tolist()
                host = [parity.leaf_hash_host(tree[n]) for n in sorted(tree)]
                out["device_is_host"] = dev == host
                out["leaves"] = len(tree)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                probe.check(tree)
                out["probe_ms"] = (time.perf_counter() - t0) * 1e3
                if flip:
                    if rank == 1:
                        with torch.no_grad():
                            p = dict(m.named_parameters())[PARITY_FLIP_LEAF]
                            p.view(-1)[:1].view(torch.int32).bitwise_xor_(1)
                    out["flip_record"] = parity.maybe_observe(step,
                                                              mesh=mesh)
            return out
        return LoopbackWorld(2).run(fn)

    try:
        armed = dp_run(True, flip=True)
        checks = monitor.get_stat("parity_checks_total")
        div = monitor.get_stat("parity_divergence_total")
        ev = observability.flight.recent(8, kind="parity.divergence")
        named = ev[-1]["attrs"]["first_bad_leaf"] if ev else None
        r["dp2_losses"] = armed[0]["losses"]
        r["device_hash_is_host"] = [a["device_is_host"] for a in armed]
        r["probe_ms"] = [a["probe_ms"] for a in armed]
        r["probed_leaves"] = armed[0]["leaves"]
        r["parity_checks"], r["divergence_named"] = checks, named
        log(f"parity: dp = 2 ShardedUpdateTrainStep (f32 wire), GPT-2 345M's "
            f"width, {PARITY_LAYERS} layers, {PARITY_STEPS} steps armed "
            f"every step: {checks} probes (the last after a flipped bit), "
            f"{div} divergence naming {named!r}; each rank's device hash of "
            f"its {r['probed_leaves']} replicated leaves is leaf_hash_host "
            f"of its host copy: {r['device_hash_is_host']}; probe ms "
            f"{[round(v, 2) for v in r['probe_ms']]} [{power}]")
        if not all(r["device_hash_is_host"]):
            fail("parity: a device hash differs from leaf_hash_host")
        if checks != PARITY_STEPS + 1 or div != 1 or \
                named != PARITY_FLIP_LEAF:
            fail(f"parity: {checks} checks, {div} divergences naming "
                 f"{named!r}; want {PARITY_STEPS + 1}, 1, "
                 f"{PARITY_FLIP_LEAF!r}")
        del armed
        planes_reset()
        plain = dp_run(False)
        same = plain[0]["losses"] == r["dp2_losses"]
        r["disarmed_losses_bitwise"] = same
        # the synchronisations of one step, disarmed and with the hook out
        syncs = {}
        for what in ("disarmed", "hook_out"):
            real = parity.maybe_observe
            if what == "hook_out":
                parity.maybe_observe = lambda *a, **k: None
            try:
                syncs[what], _ = count_syncs(lambda: dp_run(False, steps=1))
            finally:
                parity.maybe_observe = real
        r["syncs_dp2_step"] = syncs
        log(f"parity: disarmed, the losses are the armed run's bitwise: "
            f"{same}; synchronisations of a dp = 2 run of one step (both "
            f"ranks, the build included) {syncs} [{power}]")
        if not same or syncs["disarmed"] != syncs["hook_out"]:
            fail("parity: the disarmed probe changed the losses or added a "
                 "synchronisation")
        del plain

        # (b) ShardedTrainStep at mp = 2 with numerics armed
        set_flags({"replica_parity": False, "numerics": True})
        init_np = {n: t.cpu() for n, t in init.items()}

        def mp_fn(rank, mesh, steps=PARITY_STEPS, plant=False):
            m = GPT(cfg2, device="cuda", mesh=mesh)
            shards = shard_params(init_np, 2, mesh.axis_index("mp"))
            with torch.no_grad():
                for n, p in m.named_parameters():
                    p.copy_(shards[n])
            step = ShardedTrainStep(m, gpt_loss, AdamW(learning_rate=1e-4),
                                    mesh=mesh, **amp)
            split = {n: getattr(p, "mp_split", None) is not None
                     for n, p in m.named_parameters()}
            rows = []
            for _ in range(steps):
                params = step._params()
                before = {n: p.detach().clone() for n, p in params.items()}
                _, grads = loss_and_grads(step._loss_from, params,
                                          [ids_t, ids_t])
                step(ids_t, ids_t)
                rec = step.last_numerics
                rows.append((_f64_partials(grads, before, params, split),
                             rec.grad_norm, rec.param_norm, rec.update_norm,
                             rec.per_leaf()))
                del grads, before
            return rows
        out = LoopbackWorld(2).run(mp_fn, axes={"mp": 2})
        errs = []
        for k in range(PARITY_STEPS):
            tot = [0.0, 0.0, 0.0]
            for rank, rows in enumerate(out):
                for g2, p2, u2, is_split in rows[k][0].values():
                    if is_split or rank == 0:
                        tot[0] += g2
                        tot[1] += p2
                        tot[2] += u2
            want = [math.sqrt(v) for v in tot]
            got = out[0][k][1:4]
            errs.append([abs(a - b) / b for a, b in zip(got, want)])
            if out[1][k][1:] != out[0][k][1:]:
                fail(f"numerics at mp = 2: the ranks' records differ at "
                     f"step {k}")
        r["mp2_numerics_rel_err"] = errs
        # the planted record: the sum over mp left out
        real = sharded.numerics.sum_aux_over

        def no_mp(aux, axes):
            return real(aux, [a for a in axes if not (
                any(a[1]) and not all(a[1]))])
        sharded.numerics.sum_aux_over = no_mp
        try:
            bad = LoopbackWorld(2).run(
                lambda rank, mesh: mp_fn(rank, mesh, steps=1), axes={"mp": 2})
        finally:
            sharded.numerics.sum_aux_over = real
        tot = sum(g2 for rank, rows in enumerate(bad)
                  for g2, _, _, s in rows[0][0].values() if s or rank == 0)
        r["mp2_planted_rel_err"] = abs(bad[0][0][1] - math.sqrt(tot)) / \
            math.sqrt(tot)
        log(f"numerics at mp = 2 (ShardedTrainStep, GPT-2 345M's width, "
            f"{PARITY_LAYERS} layers, O2): grad / param / update norms "
            f"against the f64 recompute, relative errors a step {errs} "
            f"(tol {TOL_NUMERICS:g}), equal on both ranks; the planted "
            f"record without the sum over mp: grad norm off by "
            f"{r['mp2_planted_rel_err']:.3g} [{power}]")
        if max(max(e) for e in errs) > TOL_NUMERICS:
            fail("numerics at mp = 2: a norm is off the f64 recompute")
        if r["mp2_planted_rel_err"] <= TOL_NUMERICS:
            fail("numerics at mp = 2: the planted record is within the "
                 "tolerance")
    finally:
        set_flags(saved)
        torch.cuda.empty_cache()
    launches = _flash_launches(fa)
    r["launches"] = launches
    return r, launches


def _elastic_step():
    """The elastic worker's step: GPT-2 345M's width at ELASTIC_LAYERS
    layers, B = 8, S = 1024, remat=False, O2 bf16, AdamW(1e-4)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPT, gpt2_345m, gpt_loss
    from paddle_tpu_torch.optimizer import AdamW
    cfg = gpt2_345m(max_seq_len=S, remat=False)
    cfg.num_layers, cfg.seed = ELASTIC_LAYERS, 63
    return TrainStep(GPT(cfg, device="cuda"), gpt_loss,
                     AdamW(learning_rate=1e-4), amp_level="O2",
                     amp_dtype="bfloat16")


def _elastic_batches():
    import numpy as np
    import torch
    rng = np.random.default_rng(63)
    return [torch.from_numpy(rng.integers(0, 50304, (B, S), dtype=np.int64))
            .to("cuda") for _ in range(ELASTIC_STEPS)]


def _leaf_hashes(model):
    from paddle_tpu_torch.parallel.parity import leaf_hash_device
    return {n: int(leaf_hash_device(p)) for n, p in model.named_parameters()}


def elastic_gpt_worker(root):
    """The worker phase 63 launches through ``paddle_tpu_torch.distributed.
    launch`` under an ElasticAgent: it resumes from the newest committed
    generation under ``root``, trains to ELASTIC_STEPS, commits a
    generation after every 2nd step but the last, beats the store after
    each step, and (its first incarnation only) hangs in the beat of the
    last step (``elastic.worker_hang``): the first incarnation is the
    uninterrupted run.  Each step appends {pid, restored, step, loss,
    time} to ``root/steps.jsonl``; the last step writes the parameters'
    hashes to ``root/final_<pid>.json`` before its beat."""
    from paddle_tpu_torch.distributed import elastic
    from paddle_tpu_torch.distributed.durable import CheckpointManager
    from paddle_tpu_torch.framework import chaos
    store = elastic.FileStore(
        os.environ["PADDLE_ELASTIC_STORE"],
        ttl=float(os.environ["PADDLE_ELASTIC_LEASE_TTL"]))
    ctx = elastic.ElasticWorkerContext(
        store, os.environ["PADDLE_ELASTIC_WORKER_ID"], renew_interval=0.0)
    step = _elastic_step()
    mgr = CheckpointManager(os.path.join(root, "gens"), keep_last=4)
    start = mgr.restore(step) or 0
    marker = os.path.join(root, "hang_armed")
    if not os.path.exists(marker):
        open(marker, "w").close()
        chaos.arm("elastic.worker_hang", mode="latency", latency=600.0,
                  nth=ELASTIC_STEPS, n_times=1)
    batches = _elastic_batches()
    for t in range(start, ELASTIC_STEPS):
        loss = float(step(batches[t], batches[t]))
        with open(os.path.join(root, "steps.jsonl"), "a") as f:
            f.write(json.dumps({"pid": os.getpid(), "restored": start,
                                "step": t, "loss": loss,
                                "time": time.time()}) + "\n")
        if t % 2 == 1 and t < ELASTIC_STEPS - 1:
            mgr.save(step, t + 1, mode="sync")
        if t == ELASTIC_STEPS - 1:
            with open(os.path.join(root, f"final_{os.getpid()}.json"),
                      "w") as f:
                json.dump(_leaf_hashes(step.model), f)
        ctx.step_done(t)


_ELASTIC_BOOT = """import os, sys
card = os.environ.pop("ELASTIC_WORKER_CARD")
if card == "-":
    os.environ.pop("CUDA_VISIBLE_DEVICES", None)
else:
    os.environ["CUDA_VISIBLE_DEVICES"] = card
sys.path.insert(0, {here!r})
import chip_smoke
chip_smoke.elastic_gpt_worker(sys.argv[1])
"""


def elastic_phase(fa, power):
    """Phase 63 (elastic and launch): ``python -m paddle_tpu_torch.
    distributed.launch --elastic_store ...`` runs an ElasticAgent on a
    FileStore over one worker (elastic_gpt_worker) on the card, the
    launcher itself with the card hidden.  The worker trains GPT-2 345M's
    width at ELASTIC_LAYERS layers and commits generations;
    ``elastic.worker_hang`` stalls its beat of the last step past
    the agent's ELASTIC_DEADLINE; the agent kills it and starts a
    replacement, which resumes from the newest committed generation and
    ends bitwise the uninterrupted run (the first incarnation, which
    finished every step before its last beat hung: the losses of the
    steps taken again and the parameters' hashes).  Readings: seconds to
    recover (the hung beat to the replacement's first step), seconds from
    the launch to the first worker's first step and of the whole job, the
    card's compute apps while the worker trains (the launcher and its
    agent are not among them)."""
    import shutil as _sh
    import tempfile
    r = {}
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="elastic_gpt_")
    try:
        worker = os.path.join(root, "worker.py")
        with open(worker, "w") as f:
            f.write(_ELASTIC_BOOT.format(here=here))
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   ELASTIC_WORKER_CARD=os.environ.get(
                       "CUDA_VISIBLE_DEVICES", "-"),
                   PYTHONPATH=os.pathsep.join(
                       [here] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        apps_before = _compute_apps()
        t0, w0 = time.perf_counter(), time.time()
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--elastic_store", os.path.join(root, "es"),
             "--elastic_retries", "1", "--hang_deadline",
             str(ELASTIC_DEADLINE), "--lease_ttl", "600",
             "--restart_backoff", "0.2", "--log_dir",
             os.path.join(root, "log"), worker, root],
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        steps_file = os.path.join(root, "steps.jsonl")
        apps = None
        try:
            while proc.poll() is None and time.perf_counter() - t0 < 600:
                if apps is None and os.path.exists(steps_file):
                    apps = _compute_apps()
                time.sleep(0.2)
            out, _ = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        r["launcher_rc"] = proc.returncode
        r["job_s"] = time.perf_counter() - t0
        rows = [json.loads(x) for x in open(steps_file)]
        pids = sorted({x["pid"] for x in rows}, key=lambda p: min(
            x["time"] for x in rows if x["pid"] == p))
        first = [x for x in rows if x["pid"] == pids[0]]
        second = [x for x in rows if x["pid"] == pids[-1]]
        want = [x["loss"] for x in first]
        got = {x["step"]: x["loss"] for x in rows}
        finals = [os.path.join(root, f"final_{p}.json") for p in pids]
        want_hash, final = (json.load(open(f)) if os.path.exists(f) else {}
                            for f in (finals[0], finals[-1]))
        r["incarnations"] = len(pids)
        r["restored_generation"] = second[0]["restored"] if second else None
        r["recover_s"] = second[0]["time"] - first[-1]["time"] \
            if len(pids) > 1 else None
        r["first_step_s"] = first[0]["time"] - w0
        r["losses"] = [got.get(t) for t in range(ELASTIC_STEPS)]
        r["compute_apps_before"], r["compute_apps"] = apps_before, apps
        r["agent_on_card"] = apps is None or len(apps) != \
            len(apps_before) + 1
        log(f"elastic: launch --elastic_store (ElasticAgent over a "
            f"FileStore) ran one worker (GPT-2 345M's width, "
            f"{ELASTIC_LAYERS} layers, O2) for {ELASTIC_STEPS} steps: rc "
            f"{r['launcher_rc']}, {r['incarnations']} incarnations, the "
            f"replacement restored generation {r['restored_generation']}, "
            f"{r['recover_s'] and round(r['recover_s'], 2)} s from the hung "
            f"beat to the replacement's first step (deadline "
            f"{ELASTIC_DEADLINE:g} s; {r['first_step_s']:.2f} s from the "
            f"launch to the first worker's first step; the job "
            f"{r['job_s']:.2f} s), losses {r['losses']} against the "
            f"uninterrupted first incarnation's {want}; the replacement's "
            f"final parameters hash as the first's: {final == want_hash}; "
            f"the card's compute apps while the "
            f"worker trained {apps}, before {apps_before} [{power}]")
        ok_hash = bool(final) and final == want_hash
        r["final_bitwise"] = ok_hash
        if r["launcher_rc"] != 0 or r["incarnations"] != 2:
            fail(f"elastic: the launcher ended {r['launcher_rc']} after "
                 f"{r['incarnations']} incarnations: {out[-1500:]}")
        if r["restored_generation"] != ELASTIC_STEPS - 2:
            fail(f"elastic: the replacement restored generation "
                 f"{r['restored_generation']}, not {ELASTIC_STEPS - 2}")
        if r["losses"] != want or not ok_hash:
            fail("elastic: the resumed run is not the uninterrupted run "
                 "bitwise")
        if r["agent_on_card"]:
            fail(f"elastic: the card's compute apps {apps} (before "
                 f"{apps_before}): the agent holds a context")
    finally:
        _sh.rmtree(root, ignore_errors=True)
    return r


def autopilot_leg(step, ids, x, y, dry_small, power):
    """Phase 57's autopilot leg (ROADMAP item 6b, the third of phase 63's
    parts), on the phase's remote PSTrainStep with the server up.  A dry
    run at the small size (``dry_small``: the remote prefetched run with a
    dry-run controller ticking every step) gives the autopilot-off run's
    losses, table and parameters bitwise.  Live: the step starts
    unpipelined (prefetch depth 0) under the tracer; the controller reads
    each interval's blame from the span file and takes ``prefetch.deepen``
    under ps_wait; examples/s before and after the action, and the
    guarded rollback's verdict one interval later."""
    import tempfile

    import torch
    from paddle_tpu_torch.framework import autopilot, blame, observability
    r = {}
    ok, decisions = dry_small()
    r["dry_run_bitwise"] = ok
    r["dry_run_decisions"] = [d["kind"] for d in decisions]
    log(f"autopilot: a dry run (decisions {r['dry_run_decisions']}, every "
        f"one dry) on the small remote prefetched run is the autopilot-off "
        f"run bitwise: {ok} [{power}]")
    if not ok or "taken" not in r["dry_run_decisions"]:
        fail("autopilot: the dry run moved the run or decided nothing")
    tdir = tempfile.mkdtemp(prefix="autopilot_trace_")
    tracer = observability.tracer
    step.flush()
    step.set_prefetch_depth(0)

    def interval_blame():
        res = blame.compute_blame(blame.load_trace_dir(tdir))
        rows = res["steps"][-AUTOPILOT_INTERVAL:]
        return {"per_step_ms": {c: sum(w["blame_ms"][c] for w in rows)
                                / max(len(rows), 1)
                                for c in blame.CATEGORIES}}
    ctl = autopilot.Controller(
        step=step, blame_source=interval_blame, dry_run=False,
        interval_steps=AUTOPILOT_INTERVAL, hysteresis=1, cooldown_s=0.0,
        max_actions=2, rollback_intervals=1, rollback_tolerance=0.25,
        max_prefetch_depth=1)
    tracer.enable(tdir, label="autopilot")
    ms, taken_at = [], None
    try:
        for i in range(AUTOPILOT_INTERVAL * AUTOPILOT_INTERVALS):
            step.prefetch(ids)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step(ids, x, y))
            ms.append((time.perf_counter() - t0) * 1e3)
            made = ctl.tick()
            if taken_at is None and any(d["kind"] == "taken" for d in made):
                taken_at = i + 1
    finally:
        tracer.disable()
        step.flush()
    kinds = [(d["kind"], d["action"]) for d in ctl.decisions]
    r["decisions"] = kinds
    r["depth_after"] = step.prefetch_depth
    if taken_at is not None:
        before, after = ms[:taken_at], ms[taken_at:]
        r["examples_per_s_before"] = PS_B / (sum(before) / len(before)) * 1e3
        r["examples_per_s_after"] = PS_B / (sum(after) / len(after)) * 1e3
    r["rollback_verdict"] = "reverted" if ("reverted", "prefetch.deepen") \
        in kinds else "kept"
    log(f"autopilot: live on the remote step (B={PS_B}), intervals of "
        f"{AUTOPILOT_INTERVAL} steps: decisions {kinds}; examples/s before "
        f"the action {r.get('examples_per_s_before')}, after "
        f"{r.get('examples_per_s_after')}; the rollback guard's verdict "
        f"{r['rollback_verdict']}, prefetch depth now {r['depth_after']} "
        f"[{power}]")
    if ("taken", "prefetch.deepen") not in kinds:
        fail(f"autopilot: prefetch.deepen was not taken under ps_wait: "
             f"{kinds}")
    return r


def vision_loss_of(out, y):
    from paddle_tpu_torch.nn.functional import cross_entropy
    return cross_entropy(out, y).mean()


def main() -> int:
    t_start = time.perf_counter()
    clock = PhaseClock()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.framework.selected_rows import SelectedRows
    from paddle_tpu_torch.jit import (TrainStep, functional_loss_call,
                                      loss_and_grads, loss_closure)
    from paddle_tpu_torch.models import (GPT, Bert, BertConfig, bert_base,
                                         bert_pretrain_loss, gpt2_345m,
                                         gpt_loss, gpt_tiny)
    from paddle_tpu_torch.nn.initializer import Constant
    from paddle_tpu_torch import tensor as ttensor
    from paddle_tpu_torch.nn.functional.attention import _xla_attention
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_adam
    from paddle_tpu_torch.ops.cuda import fused_ce
    from paddle_tpu_torch.ops.cuda import ring_quant
    from paddle_tpu_torch import amp, regularizer
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum
    from paddle_tpu_torch.tools.profile_gpt import gc_time
    from paddle_tpu_torch.vision import ops as vops
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.models import (LeNet, mobilenet_v1,
                                                mobilenet_v2, resnet18,
                                                resnet50, vgg16)

    # f32 products in full f32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    prefetch = draw_once()
    card = torch.cuda.get_device_name(0)
    power = card_power()
    log(f"device: {card}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}; nvidia-smi: {power}")

    # -- 1. build -----------------------------------------------------------
    clock.begin(1, "build")
    t0 = time.perf_counter()
    # the first GPT-2 345M (phase 3) and BERT-base (phase 7) draw meanwhile
    prefetch(gpt2_345m(max_seq_len=S, remat=False))
    prefetch(bert_base(max_seq_len=BERT_S))
    logs = _build.build_all()
    log(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        if not text and (_build.BUILD_DIR / f"{name}.log").exists():
            text = logs[name] = (_build.BUILD_DIR / f"{name}.log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    # ptxas serialises a kernel's wgmma products when it cannot keep them
    # in flight (warning C7515 and its kin): no wgmma kernel may have it
    for name in ("flash_attention_fwd", "flash_attention_bwd",
                 "flash_attention_dbias", "fused_ce_fwd", "fused_ce_bwd"):
        serial = [line.strip() for line in logs[name].splitlines()
                  if "wgmma" in line and "serializ" in line]
        log(f"build: wgmma serialisation warnings in {name}: {len(serial)}")
        if serial:
            fail(f"ptxas serialised the wgmma products of {name}: "
                 + " | ".join(serial))

    # -- 2. check -----------------------------------------------------------
    clock.begin(2, "check")
    g = torch.Generator(device="cuda").manual_seed(0)
    H_ = 16
    fa_err = max(check_flash(g, fa, c) for c in [
        (B * H_, S, S, 64, bf16, True),        # GPT-2 345M layer shape
        (B * H_, S, S, 128, bf16, True),
        (B * H_, 1000, 1000, 64, bf16, True),  # tails inside a 128 tile
        (B * H_, 1088, 1088, 128, bf16, True),  # tails of 64 rows / keys
        (16, 1088, 1088, 64, bf16, False),
        (16, 1088, 1000, 64, bf16, True),      # sq > sk: rows with no key
        (16, 320, 128, 128, bf16, True),
        (16, 128, 384, 64, bf16, True),        # sq < sk
        (BERT_B * BERT_HEADS, BERT_S, BERT_S, 64, bf16, False),
    ])
    # B*H across the seam where grid y once split the launches
    fa_err = max(fa_err, check_flash(g, fa, (FA_SEAM + 4465, 128, 128, 64,
                                             bf16, True),
                                     slices=(0, FA_SEAM - 1, FA_SEAM,
                                             FA_SEAM + 4464)))
    for c in [(4, 256, 256, 64, f32, True), (4, 200, 200, 128, f32, False),
              (4, 200, 128, 64, f32, True)]:   # sq > sk: rows with no key
        check_flash(g, fa, c)
    bwd_errs = [check_flash_bwd(g, fa, c) for c in [
        (B * H_, S, S, 64, bf16, True),        # GPT-2 345M layer shape
        (B * H_, S, S, 128, bf16, True),
        (B * H_, 1000, 1000, 64, bf16, True),  # tails inside a 128 tile
        (B * H_, 1088, 1088, 128, bf16, True),  # tails of 64 rows / keys
        (16, 1088, 1088, 64, bf16, False),
        (16, 1088, 1000, 64, bf16, True),      # sq > sk: rows with no key
        (16, 320, 128, 128, bf16, True),
        (16, 128, 384, 64, bf16, True),        # sq < sk
        (BERT_B * BERT_HEADS, BERT_S, BERT_S, 64, bf16, False),
    ]]
    # B*H across the seam where grid y once split the launches
    bwd_errs.append(check_flash_bwd(g, fa, (FA_SEAM + 4465, 128, 128, 64,
                                            bf16, True),
                                    slices=(0, FA_SEAM - 1, FA_SEAM,
                                            FA_SEAM + 4464)))
    dq_err = max(e[0] for e in bwd_errs)
    dkv_err = max(e[1] for e in bwd_errs)
    for c in [(4, 256, 256, 64, f32, True), (4, 200, 200, 128, f32, False),
              (4, 200, 128, 64, f32, True)]:   # sq > sk: rows with no key
        check_flash_bwd(g, fa, c)
    ce_err = max(check_ce(g, fused_ce, c) for c in [
        (B * S, 1024, 50304, bf16),            # GPT-2 345M scoring head
        (8000, 1024, 50304, bf16),             # token tail
        (300, 256, 1000, bf16),                # token and vocabulary tails
    ])
    check_ce(g, fused_ce, (300, 256, 1000, f32))
    pb = fused_ce.P_BUDGET
    ce_bwd_errs = [check_ce_bwd(g, fused_ce, c) for c in [
        (B * S, 1024, 50304, bf16, pb),        # GPT-2 345M training head
        (8000, 1024, 50304, bf16, pb),         # token tail
        (300, 256, 1000, bf16, CE_TAIL_BUDGET),   # token, vocabulary tails
        (300, 1280, 1025, bf16, CE_TAIL_BUDGET),  # a last chunk of 1 row
    ]]
    dh_err = max(e[0] for e in ce_bwd_errs)
    dw_err = max(e[1] for e in ce_bwd_errs)
    check_ce_bwd(g, fused_ce, (300, 256, 1000, f32, pb))
    # #8 in bf16 at GPT-2 345M's 16 stacked tensors, beside three planted
    # faults, then at tails: lengths no multiple of 8, more than 32
    # tensors; a start off a 16-byte boundary is refused
    adam_shapes = gpt_param_shapes(gpt2_345m(max_seq_len=S))
    adam_n, _ = check_adam_bf16(g, fused_adam, AdamW, adam_shapes)
    for shapes in ([(100003,), (2048 * 3 + 5,), (13,), (1,)],
                   [(4099,), (77,)], [(7,)] * 40):
        check_adam_bf16(g, fused_adam, AdamW, shapes, faults=False)
    odd = adam_bf16_inputs(g, [(4099,), (77,)], [0, 3])
    try:
        fused_adam.fused_adam(*odd, *adam_bf16_rates(AdamW, 2)[1:],
                              torch.tensor(0.0, device="cuda"), 0.9, 0.999,
                              1e-8)
    except ValueError as e:
        log(f"check fused_adam bf16 refuses a start off a 16-byte "
            f"boundary: {e}")
    else:
        fail("fused_adam bf16 took a start off a 16-byte boundary")
    log(f"check fused_adam bf16 over GPT-2 345M's 16 tensors ({adam_n} "
        f"values) and at tail shapes: bitwise its plain version, two calls "
        f"bitwise equal, every planted fault seen")

    small = gpt_tiny(num_layers=2, hidden_size=128, num_heads=2,
                     max_seq_len=256)
    ids_s = np.random.default_rng(1).integers(0, small.vocab_size, (2, 256))
    gpu_s, cpu_s = GPT(small, device="cuda"), GPT(small, device="cpu")
    with torch.inference_mode():
        e_small = float((gpu_s(ids_s).cpu() - cpu_s(ids_s)).abs().max())
        for fused in (False, True):
            set_flags({"gpt_fused_ce": fused})
            e_small = max(e_small, abs(float(gpt_loss(gpu_s, ids_s, ids_s))
                                       - float(gpt_loss(cpu_s, ids_s,
                                                        ids_s))))
    set_flags({"gpt_fused_ce": False})
    log(f"check small GPT (2 layers, H=128, S=256, f32) card vs CPU: "
        f"max_abs_err={e_small:.3g} (tol {TOL_F32:g})")
    if e_small > TOL_F32:
        fail("small GPT on the card disagrees with the CPU")
    del gpu_s, cpu_s
    e_train, e_move = check_small_train(GPT, gpt_loss, small, ids_s,
                                        TrainStep, AdamW)
    log(f"check small GPT f32 gradients and one TrainStep (AdamW) card vs "
        f"CPU: gradients and loss max_abs_err={e_train:.3g} (tol "
        f"{TOL_F32:g}), parameter moves max_err/move={e_move:.3g} (tol "
        f"{TOL_MOVE:g})")
    if e_train > TOL_F32 or e_move > TOL_MOVE:
        fail("small GPT training on the card disagrees with the CPU")
    set_flags({"gpt_fused_ce": True})
    e_fused, e_fmove = check_small_train_fused(GPT, gpt_loss, small, ids_s,
                                               TrainStep)
    set_flags({"gpt_fused_ce": False})
    log(f"check small GPT f32, three TrainSteps of the fused configuration "
        f"(fused CE, fused AdamW, clip {CLIP_SMALL:g}, warmup + cosine, "
        f"accumulate_steps={MICRO}) card vs CPU: losses max_abs_err="
        f"{e_fused:.3g} (tol {TOL_F32:g}), parameter moves max_err/move="
        f"{e_fmove:.3g} (tol {TOL_MOVE:g})")
    if e_fused > TOL_F32 or e_fmove > TOL_MOVE:
        fail("small GPT fused training on the card disagrees with the CPU")

    # the masked kernels: BERT-base's layer with its padding bias, then
    # each bias class, segment ids, and a bool mask that empties rows
    amask_l = torch.as_tensor(bert_batch(30522, BERT_B, BERT_S)[3],
                              device="cuda")
    bert_case = (BERT_B, BERT_HEADS, BERT_S, 64, bf16, None, None, False,
                 False)
    m_errs = check_masked(g, fa, bert_case, fa.Mask(
        padding_bias(amask_l), None, None, BERT_HEADS), dbias=False)[:3]
    cases = [(4, 4, 256, 64, bf16, (bb, hb, sqb, 256), bdt, False, causal)
             for bb, hb in ((1, 1), (1, 4), (4, 1), (4, 4))
             for sqb in (1, 256) for bdt in (f32, bf16)
             for causal in (False, True)]
    cases += [(4, 4, 256, 64, f32, (bb, hb, sqb, 256), f32, False,
               bool(sqb == 1))
              for bb, hb in ((1, 1), (1, 4), (4, 1), (4, 4))
              for sqb in (1, 256)]
    cases += [(4, 4, 256, d, dt, None, None, True, causal)
              for dt, d in ((bf16, 64), (f32, 128)) for causal in (False,
                                                                   True)]
    cases += [(4, 4, 256, 128, bf16, (1, 4, 256, 256), bf16, True, True)]
    # several key tiles with the diagonal, D = 128, and sq > sk (rows with
    # no key) under a mask
    cases += [(4, 4, 384, 64, bf16, (4, 1, 1, 384), f32, False, True),
              (4, 4, 384, 128, bf16, (4, 1, 1, 384), f32, True, False),
              (4, 4, (256, 128), 64, bf16, (1, 4, 256, 128), bf16, False,
               True),
              (4, 4, (384, 128), 128, bf16, (4, 1, 1, 128), f32, False,
               True)]
    # dbias splits whose last run is short (fa.dbias_plan): 20 batch terms
    # in 7 runs of 3; 80 slices in 27 runs of 3; with one query row, 69
    # slices in 35 runs of 2; at D = 128 with segment ids, 21 in 2 of 11
    cases += [(20, 4, 256, 64, bf16, (1, 4, 256, 256), bf16, False, True),
              (20, 4, 256, 64, bf16, (1, 1, 256, 256), f32, False, False),
              (23, 3, 256, 64, bf16, (1, 1, 1, 256), bf16, False, True),
              (21, 4, 256, 128, bf16, (1, 4, 256, 256), f32, True, True)]
    for c in cases:
        check_masked(g, fa, c)
    check_masked_seam(g, fa)
    keep = torch.ones(4, 1, 256, 256, dtype=torch.bool, device="cuda")
    keep[0, :, :70] = False                  # rows that see no key
    keep[3, :, 200:] = False
    for dt in (bf16, f32):
        check_masked(g, fa, (4, 4, 256, 64, dt, None, None, False, False),
                     fa.Mask(fa._canon_bias(keep, 4, 4, 256, 256), None,
                             None, 4))
    dbias_err = check_dbias_faults(g, fa, BERT_B, BERT_HEADS, BERT_S)

    e_bert, e_bmove = check_small_bert(Bert, BertConfig, bert_pretrain_loss,
                                       TrainStep, AdamW, fa)
    log(f"check small BERT (2 layers, H=128, 2 heads of 64, S=128, f32) on "
        f"a padded batch, card vs CPU: logits, loss and gradients "
        f"max_abs_err={e_bert:.3g} (tol {TOL_F32:g}), one AdamW step "
        f"parameter moves max_err/move={e_bmove:.3g} (tol {TOL_MOVE:g})")
    if e_bert > TOL_F32 or e_bmove > TOL_MOVE:
        fail("small BERT on the card disagrees with the CPU")
    e_enc = check_small_encoder(tnn, fa)
    log(f"check small learned-bias encoder (2 layers, d_model 128, 2 heads "
        f"of 64, S=128, f32) card vs CPU: output and gradients (the bias's "
        f"included) max_abs_err={e_enc:.3g} (tol {TOL_F32:g})")
    if e_enc > TOL_F32:
        fail("small learned-bias encoder on the card disagrees with the CPU")
    sv = check_small_vision(g, resnet18, TrainStep, Momentum)
    log(f"check small vision (resnet18, B={SMALL_VISION_B}, "
        f"{SMALL_VISION_HW}x{SMALL_VISION_HW}) card vs CPU: training-mode "
        f"f32 forward (loss, logits, every running stat) err="
        f"{sv['train_f32']:.3g} (tol {TOL_VISION_F32:g}); planted faults "
        f"torch_momentum={sv['torch_momentum']:.3g}, biased_variance="
        f"{sv['biased_variance']:.3g}; f64 eval-mode gradients err="
        f"{sv['eval_grads_f64']:.3g}, one Momentum step's moves "
        f"max_err/move={sv['eval_moves_f64']:.3g} (tol "
        f"{TOL_VISION_F64:g}); f32 conv2d forward and backward with cuDNN's "
        f"TF32 switched on err={sv['conv_f32']:.3g} (tol {TOL_CONV_F32:g}; "
        f"cuDNN's TF32 convolution reads {sv['tf32_conv']:.3g}), batch_norm "
        f"err={sv['bn_f32']:.3g} (tol {TOL_VISION_F32:g})")
    if sv["train_f32"] > TOL_VISION_F32 or sv["bn_f32"] > TOL_VISION_F32:
        fail("small vision training forward on the card disagrees with the "
             "CPU")
    if min(sv["torch_momentum"], sv["biased_variance"]) <= TOL_VISION_F32:
        fail("a planted batch-norm fault is not above TOL_VISION_F32")
    if max(sv["eval_grads_f64"], sv["eval_moves_f64"]) > TOL_VISION_F64:
        fail("small vision gradients or moves on the card disagree with the "
             "CPU")
    if sv["conv_f32"] > TOL_CONV_F32 or sv["tf32_conv"] <= TOL_CONV_F32:
        fail("the port's f32 convolution is not IEEE f32 on the card, or "
             "TF32 would pass TOL_CONV_F32")

    # -- 3. serve -----------------------------------------------------------
    clock.begin(3, "serve")
    # bench.py's GPT-2 legs run remat=False (bench.py:299, :345): serve,
    # train, train-fused and zero measure what they measured before the
    # port honoured remat; the remat phase runs the other forms
    cfg = gpt2_345m(max_seq_len=S, remat=False)
    t0 = time.perf_counter()
    model = GPT(cfg, device="cuda").to(bf16)
    torch.cuda.synchronize()
    log(f"serve: GPT-2 345M ({cfg.num_layers} layers, H={cfg.hidden_size}, "
        f"V={cfg.vocab_size}) built in bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    L = cfg.num_layers

    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    fused_ce.launches = 0
    counts = []
    with torch.inference_mode():
        logits = model(ids)
        next_tok = logits[:, -1].float().argmax(-1)
        counts.append((fa.launches, fused_ce.launches))
        set_flags({"gpt_fused_ce": False})
        loss_unfused = float(gpt_loss(model, ids, ids))
        counts.append((fa.launches, fused_ce.launches))
        set_flags({"gpt_fused_ce": True})
        loss_fused = float(gpt_loss(model, ids, ids))
        counts.append((fa.launches, fused_ce.launches))
    set_flags({"gpt_fused_ce": False})
    torch.cuda.synchronize()
    serve_launches = {"flash_attention_fwd": fa.launches,
                      "fused_ce_fwd": fused_ce.launches}
    if fa.launches_dq or fa.launches_dkv:
        fail("a serving request launched a backward kernel")

    log(f"serve: logits {tuple(logits.shape)} {logits.dtype}, next tokens "
        f"{next_tok[:4].tolist()}..., loss unfused={loss_unfused:.6f} "
        f"fused={loss_fused:.6f} (ln V = {math.log(cfg.vocab_size):.6f})")
    log(f"serve: launch counts after each request (flash, fused_ce): "
        f"{counts}")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail("logits are not finite values of shape (B, S, V)")
    if not (math.isfinite(loss_unfused) and math.isfinite(loss_fused)):
        fail("a loss is not finite")
    if abs(loss_unfused - loss_fused) > TOL_LOSS_BF16:
        fail(f"fused and unfused losses differ by "
             f"{abs(loss_unfused - loss_fused):.3g} > {TOL_LOSS_BF16}")
    if abs(loss_unfused - math.log(cfg.vocab_size)) > 1.0:
        fail("random-init loss is not near ln(V)")
    if counts != [(L, 0), (2 * L, 0), (3 * L, 1)]:
        fail(f"launch counts {counts} != {L} flash launches per forward "
             "and one fused_ce launch")
    del logits

    # serving-time measurements need the bf16 model; take them now and
    # free it before the training phase
    ids_t = torch.as_tensor(ids, device="cuda")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(ids_t), reps=3, warmup=1)
        set_flags({"gpt_fused_ce": False})
        torch.cuda.reset_peak_memory_stats()
        unfused_ms = cuda_ms(lambda: gpt_loss(model, ids_t, ids_t), reps=3,
                             warmup=1)
        unfused_mem = torch.cuda.max_memory_allocated()
        set_flags({"gpt_fused_ce": True})
        torch.cuda.reset_peak_memory_stats()
        fused_ms = cuda_ms(lambda: gpt_loss(model, ids_t, ids_t), reps=3,
                           warmup=1)
        fused_mem = torch.cuda.max_memory_allocated()
    set_flags({"gpt_fused_ce": False})
    w_head = model.wte.detach().clone()
    del model
    torch.cuda.empty_cache()

    # -- 4. train -----------------------------------------------------------
    clock.begin(4, "train")
    t0 = time.perf_counter()
    tmodel = GPT(cfg, device="cuda")                  # f32 masters
    step = TrainStep(tmodel, gpt_loss, AdamW(learning_rate=1e-4),
                     amp_level="O2", amp_dtype="bfloat16")
    torch.cuda.synchronize()
    log(f"train: GPT-2 345M built in f32 in {time.perf_counter() - t0:.1f} "
        f"s; TrainStep(amp_level='O2', bf16), AdamW(learning_rate=1e-4), "
        f"B={B}, S={S}, {TRAIN_STEPS} steps on one batch")
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    fused_ce.launches = 0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    loss_t, train_counts = [], []
    for i in range(TRAIN_STEPS):
        if i == 1:                                    # after one warm-up
            e0.record()
        loss_t.append(step(ids_t, ids_t))
        train_counts.append((fa.launches, fa.launches_dq, fa.launches_dkv))
    e1.record()
    torch.cuda.synchronize()
    train_launches = {"flash_attention_fwd": fa.launches,
                      "flash_attention_bwd_dq": fa.launches_dq,
                      "flash_attention_bwd_dkv": fa.launches_dkv}
    step_ms = e0.elapsed_time(e1) / (TRAIN_STEPS - 1)
    train_mem = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in loss_t]
    log(f"train: losses {losses}")
    log(f"train: launch counts after each step (flash fwd, dq, dk/dv): "
        f"{train_counts}")
    log(f"train: step {step_ms:.3f} ms (CUDA events, mean of "
        f"{TRAIN_STEPS - 1} steps after one warm-up), "
        f"{B * S / step_ms * 1e3:.1f} training tokens/s, "
        f"max_memory_allocated {train_mem} bytes")
    if not all(math.isfinite(x) for x in losses):
        fail("a training loss is not finite")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        fail("the first training loss is not near ln(V)")
    if not losses[-1] < losses[0]:
        fail("the training loss did not fall")
    want = [(L * (i + 1),) * 3 for i in range(TRAIN_STEPS)]
    if train_counts != want or fused_ce.launches:
        fail(f"launch counts {train_counts} != {L} forward, {L} dq and {L} "
             "dk/dv launches per step (and no fused_ce launch)")
    train_row = {"train_step_ms": step_ms,
                 "train_tokens_per_s": B * S / step_ms * 1e3,
                 "train_peak_bytes": train_mem, "train_losses": losses}
    # the trajectory fleet-gpt (45) must give bitwise, kept on the host
    train_final = {n: p.detach().cpu() for n, p in tmodel.named_parameters()}
    del step, tmodel, loss_t
    torch.cuda.empty_cache()

    # -- 5. train-fused -----------------------------------------------------
    clock.begin(5, "train-fused")
    t0 = time.perf_counter()
    tmodel = GPT(cfg, device="cuda")                  # f32 masters
    torch.cuda.synchronize()
    params = [p.detach() for p in tmodel.parameters()]
    n_params = sum(p.numel() for p in params)
    log(f"train-fused: GPT-2 345M built in f32 in "
        f"{time.perf_counter() - t0:.1f} s, {n_params} parameters in "
        f"{len(params)} tensors")
    # the fused Adam kernel on the model's own parameter set
    adam_mom, adam_move, adam_err, adam_in = check_adam(g, fused_adam,
                                                        params, LR_PEAK)
    ok = adam_mom <= TOL_ADAM_MOMENT and adam_move <= TOL_ADAM_MOVE
    log(f"check fused_adam over {len(params)} tensors, {n_params} elements, "
        f"lr_t of step 3: m', v' max relative err={adam_mom:.3g} (tol "
        f"{TOL_ADAM_MOMENT:g}), parameter moves max_err/move="
        f"{adam_move:.3g} (tol {TOL_ADAM_MOVE:g}), p' max_abs_err="
        f"{adam_err:.3g} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("fused_adam kernel disagrees with its plain version")
    a_grads, a_m, a_v, a_args = adam_in
    adam_ms = cuda_ms(lambda: fused_adam._launch(params, a_grads, a_m, a_v,
                                                 *a_args))
    adam_plain = cuda_ms(lambda: fused_adam.fused_adam_reference(
        params, a_grads, a_m, a_v, *a_args), reps=3)
    lib_params = [p.detach().clone().requires_grad_() for p in params]
    for lp, gr in zip(lib_params, a_grads):
        lp.grad = gr
    lib_opt = torch.optim.AdamW(lib_params, lr=LR_PEAK, weight_decay=0.01,
                                fused=True)
    adam_lib = cuda_ms(lib_opt.step)
    adam_bound, adam_by = bound(11 * n_params, 28 * n_params,
                                PEAK_F32_FLOPS)
    del lib_params, lib_opt, adam_in, a_grads, a_m, a_v
    torch.cuda.empty_cache()

    sched, opt = fused_config(LR_PEAK, 1.0)
    step = TrainStep(tmodel, gpt_loss, opt, amp_level="O2",
                     amp_dtype="bfloat16", accumulate_steps=MICRO)
    gb = MICRO * B
    ids_f = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (gb, S)), device="cuda")
    # the unfused loss of the same model and batch, O2 cast as the step's
    set_flags({"gpt_fused_ce": False})
    named = dict(tmodel.named_parameters())
    with torch.inference_mode():
        loss_ref = sum(float(functional_loss_call(
            tmodel, gpt_loss, named, [ids_f[k * B:(k + 1) * B]] * 2,
            amp=True)) for k in range(MICRO)) / MICRO
    set_flags({"gpt_fused_ce": True})
    log(f"train-fused: TrainStep(amp_level='O2', bf16, accumulate_steps="
        f"{MICRO}), FLAGS_gpt_fused_ce, AdamW(use_fused=True, "
        f"weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0), "
        f"LinearWarmup(CosineAnnealingDecay({LR_PEAK:g}, T_max=4), "
        f"warmup_steps=2)), global batch {gb} x {S}, {TRAIN_STEPS} steps "
        f"on one batch")
    torch.cuda.reset_peak_memory_stats()
    counters = ((fa, "launches"), (fa, "launches_dq"), (fa, "launches_dkv"),
                (fused_ce, "launches"), (fused_ce, "launches_dh"),
                (fused_ce, "launches_dw"), (fused_adam, "launches"))
    for mod, attr in counters:
        setattr(mod, attr, 0)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    loss_t, fused_counts, rates = [], [], []
    for i in range(TRAIN_STEPS):
        if i == 1:                                    # after one warm-up
            e0.record()
        rates.append(opt.get_lr())
        loss_t.append(step(ids_f, ids_f))
        sched.step()
        fused_counts.append(tuple(getattr(m, a) for m, a in counters))
    e1.record()
    torch.cuda.synchronize()
    set_flags({"gpt_fused_ce": False})
    fused_launches = dict(zip(
        ("flash_attention_fwd", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv", "fused_ce_fwd", "fused_ce_bwd_dh",
         "fused_ce_bwd_dw", "fused_adam"), fused_counts[-1]))
    fstep_ms = e0.elapsed_time(e1) / (TRAIN_STEPS - 1)
    tfused_mem = torch.cuda.max_memory_allocated()
    flosses = [float(x) for x in loss_t]
    log(f"train-fused: rates {rates}")
    log(f"train-fused: losses {flosses}, unfused loss of the first batch "
        f"{loss_ref:.6f}")
    log(f"train-fused: launch counts after each step (flash fwd, dq, dk/dv, "
        f"fused_ce fwd, dh, dW, fused_adam): {fused_counts}")
    log(f"train-fused: step {fstep_ms:.3f} ms (CUDA events, mean of "
        f"{TRAIN_STEPS - 1} steps after one warm-up), "
        f"{gb * S / fstep_ms * 1e3:.1f} training tokens/s, "
        f"max_memory_allocated {tfused_mem} bytes (unfused train phase, "
        f"B={B}: {train_mem})")
    if not all(math.isfinite(x) for x in flosses):
        fail("a fused training loss is not finite")
    if abs(flosses[0] - loss_ref) > TOL_LOSS_BF16:
        fail(f"the first fused training loss {flosses[0]:.6f} is not within "
             f"{TOL_LOSS_BF16} of the unfused loss {loss_ref:.6f}")
    if not flosses[-1] < flosses[0]:
        fail("the fused training loss did not fall")
    per_step = (MICRO * L,) * 3 + (MICRO,) * 3 + (
        -(-len(params) // fused_adam._MAX_TENSORS),)
    want = [tuple(c * (i + 1) for c in per_step) for i in range(TRAIN_STEPS)]
    if fused_counts != want:
        fail(f"launch counts {fused_counts} != {per_step} per step")
    train_row.update({"train_fused_step_ms": fstep_ms,
                      "train_fused_tokens_per_s": gb * S / fstep_ms * 1e3,
                      "train_fused_peak_bytes": tfused_mem,
                      "train_fused_losses": flosses,
                      "train_fused_unfused_first_loss": loss_ref})
    del step, tmodel, loss_t, params, named, opt
    torch.cuda.empty_cache()

    # -- 6. remat -----------------------------------------------------------
    clock.begin(6, "remat")
    sb_ids, _, sb_nsp, sb_amask, sb_mlm = bert_batch(512, 4, 128, seed=5)
    small_models = [
        ("GPT", lambda r, d: GPT(gpt_tiny(
            num_layers=2, hidden_size=128, num_heads=2, max_seq_len=256,
            remat=r), device=d), gpt_loss, [ids_s, ids_s]),
        ("BERT", lambda r, d: Bert(BertConfig(
            vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=128, remat=r), device=d), bert_pretrain_loss,
         [sb_ids, sb_mlm, sb_nsp, sb_amask])]
    rc_bad, rc_err = check_small_remat(small_models, loss_closure,
                                       loss_and_grads)
    log(f"remat: small GPT (2 layers, H=128, S=256) and small BERT (padded, "
        f"S=128), f32 on the card: loss and gradients with "
        f"{', '.join(f for f, _, _ in REMAT_FORMS[1:])} bitwise those "
        f"without: {'no: ' + ', '.join(rc_bad) if rc_bad else 'yes'}; the "
        f"remat model on the CPU max_abs_err={rc_err:.3g} (tol {TOL_F32:g})")
    if rc_bad or rc_err > TOL_F32:
        fail("recompute changed a small model's gradients on the card, or "
             "the card disagrees with the CPU")
    rcfg = gpt2_345m(max_seq_len=S)        # the reference's default remat
    rmodel = GPT(rcfg, device="cuda")
    init = {n: p.detach().cpu() for n, p in rmodel.named_parameters()}
    log(f"remat: GPT-2 345M trained as the train phase trains it (O2 bf16, "
        f"AdamW(1e-4), B={B}, S={S}, {TRAIN_STEPS} steps on one batch), "
        f"in {len(REMAT_FORMS)} forms from the same parameters")
    remat_runs, final0 = {}, None
    for form, remat, rc in REMAT_FORMS:
        with torch.no_grad():
            for n, p in rmodel.named_parameters():
                p.copy_(init[n])
        rcfg.remat = remat
        step = TrainStep(rmodel, gpt_loss, AdamW(learning_rate=1e-4),
                         amp_level="O2", amp_dtype="bfloat16", recompute=rc)
        # each form starts from an empty allocator cache, as a fresh
        # process would
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_fa(fa)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        loss_t, counts, host = [], [], []
        with gc_time() as gc_run:
            for i in range(TRAIN_STEPS):
                if i == 1:                            # after one warm-up
                    e0.record()
                    cpu0 = time.process_time()
                    alloc0 = torch.cuda.memory_stats()
                t0 = time.perf_counter()
                loss_t.append(step(ids_t, ids_t))
                host.append((time.perf_counter() - t0) * 1e3)
                counts.append((fa.launches, fa.launches_dq,
                               fa.launches_dkv))
            e1.record()
            torch.cuda.synchronize()
        cpu_ms = (time.process_time() - cpu0) * 1e3 / (TRAIN_STEPS - 1)
        alloc1 = torch.cuda.memory_stats()
        ms = e0.elapsed_time(e1) / (TRAIN_STEPS - 1)
        run = {"step_ms": ms, "tokens_per_s": B * S / ms * 1e3,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "losses": [float(x) for x in loss_t],
               "launches": dict(zip(("flash_attention_fwd",
                                     "flash_attention_bwd_dq",
                                     "flash_attention_bwd_dkv"),
                                    counts[-1])),
               "gc_per_step": {k: v / TRAIN_STEPS
                               for k, v in gc_run.items()},
               # the host's side of a step: the time step() takes to
               # return (it queues the kernels and reads nothing back),
               # the process's CPU time (all threads), and the caching
               # allocator's calls to the driver, over the timed steps
               "host_return_ms": sum(host[1:]) / (TRAIN_STEPS - 1),
               "process_cpu_ms": cpu_ms,
               "allocator": {k: alloc1.get(k, 0) - alloc0.get(k, 0)
                             for k in ("num_device_alloc", "num_device_free",
                                       "num_alloc_retries")}}
        final = {n: p.detach().cpu() for n, p in rmodel.named_parameters()}
        final0 = final if final0 is None else final0
        run["params_bitwise_remat_false"] = all(
            torch.equal(final[n], final0[n]) for n in final)
        # one more step with the host's ranges traced (after the reads
        # above; the next form starts from init again)
        t0 = time.perf_counter()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            step(ids_t, ids_t)
            torch.cuda.synchronize()
        run["traced_step_ms"] = (time.perf_counter() - t0) * 1e3
        run["host_ms_by_range"] = {
            e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
            if e.key == "recompute.replay"}
        del prof
        remat_runs[form] = run
        log(f"remat {form}: losses {run['losses']}; launch counts after "
            f"each step (flash fwd, dq, dk/dv): {counts}; step {ms:.3f} ms "
            f"(CUDA events, mean of {TRAIN_STEPS - 1} after one warm-up), "
            f"{run['tokens_per_s']:.1f} training tokens/s, "
            f"max_memory_allocated {run['peak_bytes']} bytes; the host a "
            f"step: step() returns after {run['host_return_ms']:.3f} ms, "
            f"process CPU {run['process_cpu_ms']:.3f} ms, the allocator "
            f"{run['allocator']}, the Python "
            f"collector {run['gc_per_step']}; one more step traced "
            f"on the host (torch.profiler, CPU): "
            f"{run['traced_step_ms']:.3f} ms wall, host ms by range "
            f"{run['host_ms_by_range']} [{power}]")
        per = L * (1 + remat + rc)
        want = [(per * (i + 1), L * (i + 1), L * (i + 1))
                for i in range(TRAIN_STEPS)]
        if counts != want:
            fail(f"remat {form}: launch counts {counts} != {per} forward, "
                 f"{L} dq and {L} dk/dv launches per step")
        del step, loss_t, final
    first = remat_runs["remat=False"]["losses"]
    log(f"remat: the remat=False trajectory is the train phase's bitwise: "
        f"{'yes' if first == train_row['train_losses'] else 'no'}")
    if first != train_row["train_losses"]:
        fail("remat: the remat=False losses are not bitwise the train "
             "phase's, from the same seeded model, batch and optimizer")
    for form, run in remat_runs.items():
        if run["losses"] != first or not run["params_bitwise_remat_false"]:
            fail(f"remat {form}: the bf16 losses or parameters are not "
                 "bitwise those of remat=False")
    rcfg.remat = False
    del rmodel, init, final0
    torch.cuda.empty_cache()

    # -- 7. bert-serve ------------------------------------------------------
    clock.begin(7, "bert-serve")
    bcfg = bert_base(max_seq_len=BERT_S)
    BL = bcfg.num_layers
    t0 = time.perf_counter()
    bmodel = Bert(bcfg, device="cuda").to(bf16)
    torch.cuda.synchronize()
    log(f"bert-serve: BERT-base ({BL} layers, H={bcfg.hidden_size}, "
        f"{bcfg.num_heads} heads, V={bcfg.vocab_size}) built in bf16 in "
        f"{time.perf_counter() - t0:.1f} s; B={BERT_B}, S={BERT_S}, padded "
        f"batch")
    b_ids, b_mlm, b_nsp, b_amask, b_mlm_pad = (
        torch.as_tensor(a, device="cuda")
        for a in bert_batch(bcfg.vocab_size, BERT_B, BERT_S))
    real = int(b_amask.sum())
    reset_fa(fa)
    bserve_counts = []
    with torch.inference_mode():
        for _ in range(3):
            mlm_l, nsp_l = bmodel(b_ids, attention_mask=b_amask)
            bserve_counts.append(fa_counts(fa))
    torch.cuda.synchronize()
    bserve_launches = dict(zip(FA_COUNTERS, bserve_counts[-1]))
    log(f"bert-serve: MLM logits {tuple(mlm_l.shape)} {mlm_l.dtype}, NSP "
        f"logits {tuple(nsp_l.shape)}, {real} real tokens of "
        f"{BERT_B * BERT_S}")
    log(f"bert-serve: launch counts after each request {FA_COUNTERS}: "
        f"{bserve_counts}")
    if tuple(mlm_l.shape) != (BERT_B, BERT_S, bcfg.vocab_size) or \
            tuple(nsp_l.shape) != (BERT_B, 2) or \
            not bool(torch.isfinite(mlm_l).all()) or \
            not bool(torch.isfinite(nsp_l).all()):
        fail("BERT logits are not finite values of shape (B, S, V), (B, 2)")
    want = [(0, 0, 0, BL * (i + 1), 0, 0, 0) for i in range(3)]
    if bserve_counts != want:
        fail(f"launch counts {bserve_counts} != {BL} masked forward "
             "launches per request and nothing else")
    del mlm_l, nsp_l
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        bserve_ms = cuda_ms(lambda: bmodel(b_ids, attention_mask=b_amask),
                            reps=5, warmup=1)
        bserve_mem = torch.cuda.max_memory_allocated()
    log(f"bert-serve: request {bserve_ms:.3f} ms (CUDA events, mean of 5), "
        f"{BERT_B * BERT_S / bserve_ms * 1e3:.1f} tokens/s "
        f"({real / bserve_ms * 1e3:.1f} real tokens/s), "
        f"max_memory_allocated {bserve_mem} bytes")
    del bmodel
    torch.cuda.empty_cache()

    # -- 8. bert-train ------------------------------------------------------
    clock.begin(8, "bert-train")
    # bench_bert's configuration (remat=True, the default; bench.py:214),
    # then, in the same call, the remat=False run this phase measured
    # before the port honoured remat
    bert_sets = {}
    for remat in (True, False):
        t0 = time.perf_counter()
        bt = Bert(bert_base(max_seq_len=BERT_S, remat=remat),
                  device="cuda")                      # f32 masters
        bstep = TrainStep(bt, bert_pretrain_loss, AdamW(learning_rate=1e-4),
                          amp_level="O2", amp_dtype="bfloat16")
        torch.cuda.synchronize()
        log(f"bert-train remat={remat}: BERT-base built in f32 in "
            f"{time.perf_counter() - t0:.1f} s; TrainStep(amp_level='O2', "
            f"bf16), AdamW(learning_rate=1e-4), bert_pretrain_loss, "
            f"B={BERT_B}, S={BERT_S}, {TRAIN_STEPS} steps unpadded then "
            f"{TRAIN_STEPS} padded on one batch")
        if remat:
            named = dict(bt.named_parameters())
            ones = torch.ones_like(b_amask)
            with torch.inference_mode():
                l_plain, l_ones = (float(functional_loss_call(
                    bt, bert_pretrain_loss, named, args, amp=True))
                    for args in ([b_ids, b_mlm, b_nsp],
                                 [b_ids, b_mlm, b_nsp, ones]))
            log(f"bert-train: first-batch loss without a mask "
                f"{l_plain:.6f}, with an all-ones mask {l_ones:.6f} (tol "
                f"{TOL_ONES_MASK:g})")
            if abs(l_plain - l_ones) > TOL_ONES_MASK:
                fail("an all-ones mask does not give the unmasked loss")
            del named
        runs = bert_sets[remat] = {}
        for kind, args in (("unpadded", (b_ids, b_mlm, b_nsp)),
                           ("padded", (b_ids, b_mlm_pad, b_nsp, b_amask))):
            torch.cuda.reset_peak_memory_stats()
            reset_fa(fa)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            loss_t, counts = [], []
            for i in range(TRAIN_STEPS):
                if i == 1:                            # after one warm-up
                    e0.record()
                loss_t.append(bstep(*args))
                counts.append(fa_counts(fa))
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / (TRAIN_STEPS - 1)
            losses = [float(x) for x in loss_t]
            runs[kind] = {"step_ms": ms,
                          "tokens_per_s": BERT_B * BERT_S / ms * 1e3,
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "losses": losses,
                          "launches": dict(zip(FA_COUNTERS, counts[-1]))}
            what = f"bert-train remat={remat} {kind}"
            log(f"{what}: losses {losses}")
            log(f"{what}: launch counts after each step {FA_COUNTERS}: "
                f"{counts}")
            log(f"{what}: step {ms:.3f} ms (CUDA events, mean of "
                f"{TRAIN_STEPS - 1} steps after one warm-up), "
                f"{BERT_B * BERT_S / ms * 1e3:.1f} training tokens/s, "
                f"max_memory_allocated {runs[kind]['peak_bytes']} bytes "
                f"[{power}]")
            if not all(math.isfinite(x) for x in losses):
                fail("a BERT training loss is not finite")
            if not losses[-1] < losses[0]:
                fail(f"the {what} training loss did not fall")
            fwd = BL * (1 + remat)            # a remat layer's replay
            per = ((0, 0, 0, fwd, BL, BL) if kind == "padded"
                   else (fwd, BL, BL, 0, 0, 0))
            want = [tuple(c * (i + 1) for c in per) + (0,)
                    for i in range(TRAIN_STEPS)]
            if counts != want:
                fail(f"{what} launch counts {counts} != {per} per step and "
                     "no dbias launch")
        del bstep, bt, loss_t
        torch.cuda.empty_cache()
    bert_runs, bert_plain = bert_sets[True], bert_sets[False]
    ln_vn = math.log(bcfg.vocab_size) + math.log(2)
    if abs(bert_runs["unpadded"]["losses"][0] - ln_vn) > 1.0:
        fail(f"the first BERT loss is not near ln V + ln 2 = {ln_vn:.4f}")
    for kind in ("unpadded", "padded"):
        if bert_runs[kind]["losses"] != bert_plain[kind]["losses"]:
            fail(f"bert-train {kind}: the remat=True losses are not bitwise "
                 "those of remat=False")
    retention = (bert_runs["padded"]["tokens_per_s"]
                 / bert_runs["unpadded"]["tokens_per_s"])
    ratios = {k: (bert_runs[k]["step_ms"] / bert_plain[k]["step_ms"],
                  bert_runs[k]["peak_bytes"] / bert_plain[k]["peak_bytes"])
              for k in ("unpadded", "padded")}
    log(f"bert-train: padded / unpadded tokens/s = {retention:.4f} "
        "(bench.py's bert_padded_mask_tokens_per_sec_per_chip over "
        "bert_base_pretrain_tokens_per_sec_per_chip), remat=True; "
        "remat=True / remat=False: "
        + ", ".join(f"{k} step {r[0]:.4f}, peak bytes {r[1]:.4f}"
                    for k, r in ratios.items()))

    # -- 9. encoder-bias ----------------------------------------------------
    clock.begin(9, "encoder-bias")
    enc = biased_encoder(tnn, 768, BERT_HEADS, 3072, BL, BERT_S, None)
    estep = TrainStep(enc, mse_loss, AdamW(learning_rate=1e-4),
                      amp_level="O2", amp_dtype="bfloat16")
    ex, etarget = (rand(g, (BERT_B, BERT_S, 768), f32) for _ in range(2))
    log(f"encoder-bias: TransformerEncoder(TransformerEncoderLayer(768, "
        f"{BERT_HEADS}, 3072, dropout=0.0, activation='gelu'), {BL}) with a "
        f"learned (1, {BERT_HEADS}, {BERT_S}, {BERT_S}) src_mask bias, mean "
        f"square error against a fixed target, TrainStep(amp_level='O2', "
        f"bf16), AdamW(learning_rate=1e-4), B={BERT_B}, S={BERT_S}, "
        f"{TRAIN_STEPS} steps")
    torch.cuda.reset_peak_memory_stats()
    reset_fa(fa)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    loss_t, enc_counts = [], []
    for i in range(TRAIN_STEPS):
        if i == 1:
            e0.record()
        loss_t.append(estep(ex, etarget))
        enc_counts.append(fa_counts(fa))
    e1.record()
    torch.cuda.synchronize()
    enc_ms = e0.elapsed_time(e1) / (TRAIN_STEPS - 1)
    enc_mem = torch.cuda.max_memory_allocated()
    enc_losses = [float(x) for x in loss_t]
    enc_launches = dict(zip(FA_COUNTERS, enc_counts[-1]))
    bias_move = float(enc.bias.detach().abs().max())
    log(f"encoder-bias: losses {enc_losses}, the bias moved by at most "
        f"{bias_move:.3g}")
    log(f"encoder-bias: launch counts after each step {FA_COUNTERS}: "
        f"{enc_counts}")
    log(f"encoder-bias: step {enc_ms:.3f} ms (CUDA events, mean of "
        f"{TRAIN_STEPS - 1} steps after one warm-up), "
        f"{BERT_B * BERT_S / enc_ms * 1e3:.1f} training tokens/s, "
        f"max_memory_allocated {enc_mem} bytes")
    if not all(math.isfinite(x) for x in enc_losses) or \
            not enc_losses[-1] < enc_losses[0]:
        fail("the encoder-bias loss is not finite or did not fall")
    if not bias_move > 0:
        fail("the learned bias did not move")
    want = [(0, 0, 0) + (BL * (i + 1),) * 4 for i in range(TRAIN_STEPS)]
    if enc_counts != want:
        fail(f"launch counts {enc_counts} != {BL} masked forward, dq, dk/dv "
             "and dbias launches per step")
    del estep, enc, loss_t, ex, etarget
    torch.cuda.empty_cache()

    # -- 10. zero -----------------------------------------------------------
    clock.begin(10, "zero")
    z = zero_phase(g, cfg, ids_t, fa)
    grows, quant_err, zero_launch = z["grows"], z["quant_err"], z["launches"]

    # -- 11. longseq --------------------------------------------------------
    clock.begin(11, "longseq")
    # bench_longseq_flash's accelerator leg.  First one layer's flash
    # kernels at both of its shapes against their plain versions (at
    # S=8192 the f32 scores, 2.1 GB, fit), with the planted faults: at
    # S=2048 the persistent walk has 128 items for 132 SMs, at S=8192 512.
    # Then each kernel's time beside SDPA's and its bound at S=8192.
    long_errs = {}
    for s_len in (LONG_S_REF, LONG_S):
        lcase = (LONG_B * LONG_HEADS, s_len, s_len,
                 LONG_WIDTH // LONG_HEADS, bf16, True)
        long_errs[s_len] = (check_flash(g, fa, lcase),
                            *check_flash_bwd(g, fa, lcase))
    log(f"longseq: #1, #2, #3 at bh={LONG_B * LONG_HEADS} d="
        f"{LONG_WIDTH // LONG_HEADS} bf16 causal against their plain "
        f"versions, max_abs_err (out, dq, dk/dv) by S: {long_errs}")
    long_k = attention_times(g, fa, F, LONG_B, LONG_HEADS, LONG_S,
                             LONG_WIDTH // LONG_HEADS, True)
    log(f"longseq: kernels at bh={LONG_B * LONG_HEADS} s={LONG_S} d="
        f"{LONG_WIDTH // LONG_HEADS} bf16 causal: {json.dumps(long_k)} "
        f"[{power}]")
    rng_l = np.random.default_rng(0)
    longseq = {}
    for s_len, iters in ((LONG_S_REF, LONG_ITERS_REF), (LONG_S, LONG_ITERS)):
        lcfg = gpt_tiny(num_layers=LONG_LAYERS, hidden_size=LONG_WIDTH,
                        num_heads=LONG_HEADS, vocab_size=LONG_VOCAB,
                        max_seq_len=s_len, remat=True)
        lmodel = GPT(lcfg, device="cuda")
        lstep = TrainStep(lmodel, gpt_loss, AdamW(learning_rate=1e-4),
                          amp_level="O2", amp_dtype="bfloat16")
        lids = torch.as_tensor(rng_l.integers(0, LONG_VOCAB, (LONG_B, s_len)),
                               device="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_fa(fa)
        loss_t, counts = [], []
        for _ in range(LONG_WARMUP):
            loss_t.append(lstep(lids, lids))
            counts.append(fa_counts(fa)[:3])
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            loss_t.append(lstep(lids, lids))
            counts.append(fa_counts(fa)[:3])
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / iters
        run = {"step_ms": ms, "tokens_per_s": LONG_B * s_len / ms * 1e3,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "losses": [float(x) for x in loss_t],
               "launches": dict(zip(("flash_attention_fwd",
                                     "flash_attention_bwd_dq",
                                     "flash_attention_bwd_dkv"),
                                    counts[-1]))}
        longseq[s_len] = run
        log(f"longseq S={s_len}: gpt_tiny({LONG_LAYERS} layers, "
            f"H={LONG_WIDTH}, {LONG_HEADS} heads, V={LONG_VOCAB}, "
            f"remat=True), TrainStep(O2 bf16), AdamW(1e-4), B={LONG_B}: "
            f"losses {run['losses']}; launch counts after each step "
            f"(flash fwd, dq, dk/dv): {counts}; step {ms:.3f} ms (CUDA "
            f"events, mean of {iters} after {LONG_WARMUP} warm-ups), "
            f"{run['tokens_per_s']:.1f} training tokens/s, "
            f"max_memory_allocated {run['peak_bytes']} bytes [{power}]")
        if not all(math.isfinite(x) for x in run["losses"]):
            fail(f"a longseq S={s_len} loss is not finite")
        if abs(run["losses"][0] - math.log(LONG_VOCAB)) > 1.0:
            fail(f"the first longseq S={s_len} loss is not near ln V")
        want = [(2 * LONG_LAYERS * i, LONG_LAYERS * i, LONG_LAYERS * i)
                for i in range(1, LONG_WARMUP + iters + 1)]
        if counts != want:
            fail(f"longseq S={s_len}: launch counts {counts} != "
                 f"{2 * LONG_LAYERS} forward (remat), {LONG_LAYERS} dq and "
                 f"{LONG_LAYERS} dk/dv launches per step")
        del lstep, lmodel, loss_t
        torch.cuda.empty_cache()
    long_ratio = longseq[LONG_S]["tokens_per_s"] / longseq[LONG_S_REF][
        "tokens_per_s"]
    log(f"longseq: tokens/s at S={LONG_S} / S={LONG_S_REF} = "
        f"{long_ratio:.4f} (bench.py's "
        f"gpt_longseq8k_flashattn_train_tokens_per_sec and its vs_baseline)")

    # -- 12. masked-flash ---------------------------------------------------
    clock.begin(12, "masked-flash")
    # bench_masked_flash: q, k, v and the lengths drawn in its order
    rng_m = np.random.default_rng(0)
    mq, mk, mv = (torch.as_tensor(rng_m.standard_normal(
        (MASKED_B, MASKED_S, MASKED_H, MASKED_D)), device="cuda").to(bf16)
        for _ in range(3))
    m_lens = rng_m.integers(MASKED_S // 2, MASKED_S + 1, size=(MASKED_B,))
    m_amask = torch.as_tensor(np.arange(MASKED_S)[None, :]
                              < m_lens[:, None], device="cuda")
    m_bias = padding_bias(m_amask)
    if not fa.supported(tuple(mq.shape), tuple(mk.shape), False,
                        bias_shape=tuple(m_bias.shape), dtype=bf16):
        fail("the flash kernel does not serve bench_masked_flash's shape")
    mflash_err = check_masked(
        g, fa, (MASKED_B, MASKED_H, MASKED_S, MASKED_D, bf16, None, None,
                False, False),
        fa.Mask(m_bias, None, None, MASKED_H), dbias=False)[:3]
    m_sc = MASKED_D ** -0.5
    mg = [t.detach().clone().requires_grad_() for t in (mq, mk, mv)]

    def masked_fwd_bwd(bias):
        return torch.autograd.grad(fa.flash_attention(
            *mg, scale=m_sc, bias=bias).float().sum(), mg)

    reset_fa(fa)
    for bias in (m_bias, None):
        masked_fwd_bwd(bias)
    torch.cuda.synchronize()
    mflash_launches = dict(zip(FA_COUNTERS, fa_counts(fa)))
    if fa_counts(fa) != (1, 1, 1, 1, 1, 1, 0):
        fail(f"masked-flash: launch counts {fa_counts(fa)} != one of each "
             "unmasked and masked kernel, no dbias")
    t_masked = cuda_ms(lambda: masked_fwd_bwd(m_bias), reps=20)
    t_plain = cuda_ms(lambda: masked_fwd_bwd(None), reps=20)
    mflash = {"fwd_bwd_masked_ms": t_masked, "fwd_bwd_unmasked_ms": t_plain,
              "tokens_per_s": MASKED_B * MASKED_S / t_masked * 1e3,
              "retention": t_plain / t_masked,
              "real_tokens": int(m_lens.sum())}
    mflash["kernels"] = attention_times(
        g, fa, F, MASKED_B, MASKED_H, MASKED_S, MASKED_D, False,
        amask=m_amask)
    log(f"masked-flash: B={MASKED_B}, S={MASKED_S}, {MASKED_H} heads of "
        f"{MASKED_D}, bf16, padding bias with {mflash['real_tokens']} real "
        f"tokens of {MASKED_B * MASKED_S}: fwd+bwd masked {t_masked:.4f} ms, "
        f"unmasked {t_plain:.4f} ms (CUDA events, mean of 20), "
        f"{mflash['tokens_per_s']:.1f} tokens/s, retention unmasked / "
        f"masked {mflash['retention']:.4f} (bench.py's "
        f"masked_flash_kernel_s2048_tokens_per_sec and its vs_baseline); "
        f"kernels {json.dumps(mflash['kernels'])} [{power}]")
    del mq, mk, mv, mg
    torch.cuda.empty_cache()

    # -- 13. resnet50-train ------------------------------------------------
    clock.begin(13, "resnet50-train")
    rmodel = resnet50(num_classes=1000)             # f32 masters, NCHW
    rstep = TrainStep(rmodel, vision_loss, Momentum(learning_rate=0.1,
                                                    momentum=0.9),
                      amp_level="O2", amp_dtype="bfloat16")
    rx, ry = (torch.as_tensor(a, device="cuda") for a in vision_batch(
        VISION_B, 3, VISION_HW, 1000))
    p0 = {n: p.detach().clone() for n, p in rmodel.named_parameters()}
    b0 = {n: b.clone() for n, b in rmodel.named_buffers()}
    log(f"resnet50-train: resnet50(num_classes=1000), NCHW, "
        f"{sum(p.numel() for p in p0.values())} parameters, {len(b0)} "
        f"BatchNorm buffers; TrainStep(amp_level='O2', bf16), "
        f"Momentum(0.1, 0.9), B={VISION_B} at {VISION_HW}x{VISION_HW}, one "
        f"warm-up then {VISION_STEPS} steps on one batch")
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    loss_t = [rstep(rx, ry)]
    e0.record()
    for _ in range(VISION_STEPS):
        loss_t.append(rstep(rx, ry))
    e1.record()
    torch.cuda.synchronize()
    r_ms = e0.elapsed_time(e1) / VISION_STEPS
    r_mem = torch.cuda.max_memory_allocated()
    r_losses = [float(v) for v in loss_t]
    log(f"resnet50-train: losses {r_losses}")
    log(f"resnet50-train: step {r_ms:.3f} ms (CUDA events, mean of "
        f"{VISION_STEPS} steps after one warm-up), "
        f"{VISION_B / r_ms * 1e3:.1f} samples/s, max_memory_allocated "
        f"{r_mem} bytes [{power}]")
    if not all(math.isfinite(v) for v in r_losses):
        fail("a resnet50 training loss is not finite")
    for n, b in rmodel.named_buffers():
        if not bool(torch.isfinite(b).all()) or torch.equal(b, b0[n]):
            fail(f"running stat {n} is not finite or did not move")
    for n, p in rmodel.named_parameters():
        if torch.equal(p.detach(), p0[n]):
            fail(f"resnet50 parameter {n} did not move")
    del rstep, p0, b0, loss_t
    torch.cuda.empty_cache()

    # -- 14. resnet50-eval --------------------------------------------------
    clock.begin(14, "resnet50-eval")
    rnamed = dict(rmodel.named_parameters())

    def r_forward():
        return functional_loss_call(rmodel, lambda m, x: m(x), rnamed, [rx],
                                    amp=True)
    rmodel.eval()
    with torch.inference_mode():
        r_eval = r_forward()
        rev_ms = cuda_ms(r_forward, reps=5, warmup=1)
    rmodel.train()
    stats = {n: b.clone() for n, b in rmodel.named_buffers()}
    with torch.no_grad():
        r_train_out = r_forward()
    for n, b in rmodel.named_buffers():
        b.copy_(stats[n])
    r_gap = float((r_eval - r_train_out).abs().max())
    log(f"resnet50-eval: model.eval() forward under the O2 cast, logits "
        f"{tuple(r_eval.shape)}, {rev_ms:.3f} ms a batch of {VISION_B} (CUDA "
        f"events, mean of 5), {VISION_B / rev_ms * 1e3:.1f} samples/s "
        f"[{power}]; max |eval - training-mode logits| = {r_gap:.4g}")
    if tuple(r_eval.shape) != (VISION_B, 1000) or \
            not bool(torch.isfinite(r_eval).all()):
        fail("resnet50 eval logits are not finite values of shape (B, 1000)")
    if not r_gap > 0:
        fail("the eval forward does not read the running stats")
    del rmodel, rnamed, r_eval, r_train_out, stats, rx, ry
    torch.cuda.empty_cache()

    # -- 15. lenet-train ----------------------------------------------------
    clock.begin(15, "lenet-train")
    lmodel = LeNet(num_classes=10)
    lstep = TrainStep(lmodel, vision_loss, Adam(learning_rate=1e-3))
    lx, ly = (torch.as_tensor(a, device="cuda")
              for a in vision_batch(LENET_B, 1, 28, 10))
    l_first = float(lstep(lx, ly))
    for _ in range(LENET_WARMUP):
        lstep(lx, ly)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(LENET_STEPS):
        l_last = lstep(lx, ly)
    e1.record()
    torch.cuda.synchronize()
    l_ms = e0.elapsed_time(e1) / LENET_STEPS
    l_last = float(l_last)
    log(f"lenet-train: LeNet, f32, Adam(1e-3), B={LENET_B} at 1x28x28: "
        f"first loss {l_first:.6f}, last {l_last:.6f} after "
        f"{LENET_WARMUP} warm-ups and {LENET_STEPS} steps; step {l_ms:.4f} "
        f"ms (CUDA events), {LENET_B / l_ms * 1e3:.1f} samples/s [{power}]")
    if not (math.isfinite(l_last) and l_last < l_first):
        fail("LeNet did not train: the last loss is not below the first")
    del lstep, lmodel, lx, ly
    torch.cuda.empty_cache()
    vision_row = {"resnet50_train_step_ms": r_ms,
                  "resnet50_train_samples_per_s": VISION_B / r_ms * 1e3,
                  "resnet50_train_peak_bytes": r_mem,
                  "resnet50_train_losses": r_losses,
                  "resnet50_eval_ms": rev_ms,
                  "resnet50_eval_samples_per_s": VISION_B / rev_ms * 1e3,
                  "lenet_train_step_ms": l_ms,
                  "lenet_train_samples_per_s": LENET_B / l_ms * 1e3,
                  "lenet_train_first_last_loss": [l_first, l_last],
                  "small_vision": sv}

    # -- 16. seq2seq-small --------------------------------------------------
    clock.begin(16, "seq2seq-small")
    s_err, s_falls, s_lens = seq2seq_small(tnn, fa, TrainStep, Adam)
    log(f"seq2seq-small (2 + 2 layers, d_model 128, 2 heads of 64, V=512, "
        f"S={S2S_SRC} -> {S2S_TGT}, f32) card vs CPU: max_abs_err logits="
        f"{s_err['logits']:.3g} loss={s_err['loss']:.3g} gradients="
        f"{s_err['grads']:.3g}, one Adam(1e-3) step's parameters (where "
        f"the gradient is above {GRAD_FLOOR:g})={s_err['params']:.3g} (tol "
        f"{TOL_F32:g}); {S2S_SMALL_STEPS} steps of one batch: losses "
        f"{s_falls[0]:.6f} -> {s_falls[-1]:.6f}; beam {BEAM} over "
        f"{S2S_SMALL_BEAM_STEPS} steps, lengths {s_lens}, best-beam "
        f"rescoring |err| {s_err['rescore']:.3g} (tol {TOL_RESCORE_F32:g})")
    if max(s_err["logits"], s_err["loss"], s_err["grads"],
           s_err["params"]) > TOL_F32:
        fail("the small seq2seq model on the card disagrees with the CPU")
    if not s_falls[-1] < s_falls[0]:
        fail("the small seq2seq model's loss did not fall")

    # -- 17. seq2seq-train --------------------------------------------------
    clock.begin(17, "seq2seq-train")
    s2s_bias = torch.as_tensor(seq2seq_batch(S2S_V, S2S_B, S2S_SRC,
                                             S2S_TGT)[3], device="cuda")
    s2s_err = seq2seq_kernel_checks(g, fa, s2s_bias)
    s2s_model, s2s_row, s2s_launch = seq2seq_train(tnn, fa, TrainStep, Adam,
                                                   power)

    # -- 18. seq2seq-serve --------------------------------------------------
    clock.begin(18, "seq2seq-serve")
    serve_row, serve_launch = seq2seq_serve(tnn, fa, s2s_model, power)
    del s2s_model
    torch.cuda.empty_cache()

    # -- 19. rnn ------------------------------------------------------------
    clock.begin(19, "rnn")
    rnn_rows = rnn_phase(tnn, power)

    # -- 20. eager-small ----------------------------------------------------
    clock.begin(20, "eager-small")
    opt_errs = eager_small_optimizers(tnn, topt, regularizer, tnn.ParamAttr)
    log(f"eager-small: every optimizer's eager step, {MLP_STEPS} f32 steps "
        f"of a ParamAttr MLP (rate scale, L1 and L2 regularisers, a frozen "
        f"bias), card vs CPU, max err over scale of parameters and state "
        f"{json.dumps(opt_errs)} (tol {TOL_F32:g}); state_dict -> "
        f"set_state_dict resumes bitwise")
    if max(opt_errs.values()) > TOL_F32:
        fail("an eager optimizer step on the card disagrees with the CPU")
    amp_seen = eager_small_amp(amp, tnn.functional, topt, regularizer, GPT,
                               gpt_loss, gpt_tiny, mobilenet_v2)
    log(f"eager-small: op input dtypes under auto_cast, one scaled step "
        f"each: {json.dumps(amp_seen)}")

    # -- 21. eager-gpt ------------------------------------------------------
    clock.begin(21, "eager-gpt")
    eager_row, eager_launch = eager_gpt(GPT, cfg, gpt_loss, amp, AdamW, fa,
                                        fused_adam, ids_t, power)
    log(f"eager-gpt beside the train phase's TrainStep O2 step (same "
        f"process): eager {eager_row['eager_gpt_step_ms']:.3f} ms, "
        f"{eager_row['eager_gpt_tokens_per_s']:.1f} tokens/s, peak "
        f"{eager_row['eager_gpt_peak_bytes']} bytes; TrainStep "
        f"{train_row['train_step_ms']:.3f} ms, "
        f"{train_row['train_tokens_per_s']:.1f} tokens/s, peak "
        f"{train_row['train_peak_bytes']} bytes")

    # -- 22. eager-vision ---------------------------------------------------
    clock.begin(22, "eager-vision")
    eager_row.update(eager_vision(mobilenet_v1, mobilenet_v2, vgg16, amp,
                                  tnn.functional, topt, regularizer, power))

    # -- 23. timing ---------------------------------------------------------
    clock.begin(23, "timing")
    table, kernels = [], []
    qt = rand(g, (B * H_, S, 64), bf16)
    kt, vt = rand(g, (B * H_, S, 64), bf16), rand(g, (B * H_, S, 64), bf16)
    sc = 0.125
    q4, k4, v4 = (t.view(B, H_, S, 64) for t in (qt, kt, vt))
    fa_ms = cuda_ms(lambda: fa._launch(qt, kt, vt, sc, True))
    fa_plain = cuda_ms(lambda: fa.flash_attention_reference(qt, kt, vt, sc,
                                                            True), reps=3)
    fa_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=sc))
    fa_bound, fa_by = bound(4 * B * H_ * 64 * visible_pairs(S, S, True),
                            4 * B * H_ * S * 64 * 2 + B * H_ * S * 4,
                            PEAK_BF16_FLOPS)
    # the same layer at head dim 128 (the kernel's other width)
    q8, k8, v8 = (rand(g, (B, H_, S, 128), bf16) for _ in range(3))
    q8t, k8t, v8t = (t.view(B * H_, S, 128) for t in (q8, k8, v8))
    d128 = {"ms": cuda_ms(lambda: fa._launch(q8t, k8t, v8t, 128 ** -0.5,
                                            True)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q8, k8, v8, is_causal=True, scale=128 ** -0.5)),
            "bound_ms": bound(4 * B * H_ * 128 * visible_pairs(S, S, True),
                              4 * B * H_ * S * 128 * 2 + B * H_ * S * 4,
                              PEAK_BF16_FLOPS)[0]}
    del q8, k8, v8, q8t, k8t, v8t
    table.append({"kernel": "flash_attention_fwd",
                  "shape": f"bh={B * H_} s={S} d=64 bf16 causal",
                  "kernel_ms": fa_ms, "plain_ms": fa_plain,
                  "library_ms": fa_lib, "bound_ms": fa_bound,
                  "d128_kernel_ms": d128["ms"],
                  "d128_library_ms": d128["library_ms"],
                  "d128_bound_ms": d128["bound_ms"],
                  "launches_per_forward": L})
    kernels.append({"name": "flash_attention_fwd", "route": "cuda",
                    "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
                    "replaces": "paddle_tpu/ops/pallas/flash_attention.py:190",
                    "launches": serve_launches["flash_attention_fwd"]
                    + train_launches["flash_attention_fwd"]
                    + fused_launches["flash_attention_fwd"]
                    + sum(r["launches"]["flash_attention_fwd"]
                          for r in (*remat_runs.values(),
                                    *longseq.values()))
                    + sum(r["unpadded"]["launches"]["launches"]
                          for r in (bert_runs, bert_plain))
                    + mflash_launches["launches"]
                    + eager_launch["flash_attention_fwd"],
                    "max_abs_err": fa_err, "ms": fa_ms, "plain_ms": fa_plain,
                    "bound_ms": fa_bound, "bound_by": fa_by,
                    "library_ms": fa_lib})

    # backward: the dq and dk/dv kernels, the plain backward (dq, dk, dv
    # at once), and the library's whole backward as the yardstick
    dot = rand(g, (B * H_, S, 64), bf16)
    ot, lse = fa._launch(qt, kt, vt, sc, True)
    delta = fa._delta(dot, ot)
    dq_ms = cuda_ms(lambda: fa._launch_dq(qt, kt, vt, dot, lse, delta, sc,
                                          True))
    dkv_ms = cuda_ms(lambda: fa._launch_dkv(qt, kt, vt, dot, lse, delta, sc,
                                            True))
    bwd_plain = cuda_ms(lambda: fa.flash_attention_bwd_reference(
        qt, kt, vt, ot, lse, dot, sc, True), reps=3)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    out_l = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                           scale=sc)
    do4 = dot.view(B, H_, S, 64)
    bwd_lib = cuda_ms(lambda: torch.autograd.grad(
        out_l, (ql, kl, vl), do4, retain_graph=True))
    prod = 2 * B * H_ * 64 * visible_pairs(S, S, True)   # one product
    t_bytes = B * H_ * S * 64 * 2                        # one bf16 tensor
    r_bytes = B * H_ * S * 4                             # one f32 row vector
    # dq reads q, k, v, do, lse, delta and writes dq: 3 products
    dq_bound, dq_by = bound(3 * prod, 5 * t_bytes + 2 * r_bytes,
                            PEAK_BF16_FLOPS)
    # dk/dv reads q, k, v, do, lse, delta and writes dk, dv: 4 products
    dkv_bound, dkv_by = bound(4 * prod, 6 * t_bytes + 2 * r_bytes,
                              PEAK_BF16_FLOPS)
    # the whole backward: 5 products; reads q, k, v, o, do, lse, delta and
    # writes dq, dk, dv
    pair_bound, pair_by = bound(5 * prod, 8 * t_bytes + 2 * r_bytes,
                                PEAK_BF16_FLOPS)
    table.append({"kernel": "flash_attention_bwd (dq + dk/dv)",
                  "shape": f"bh={B * H_} s={S} d=64 bf16 causal",
                  "kernel_ms": dq_ms + dkv_ms, "dq_ms": dq_ms,
                  "dkv_ms": dkv_ms, "plain_ms": bwd_plain,
                  "library_ms": bwd_lib, "bound_ms": pair_bound,
                  "bound_by": pair_by, "launches_per_step": L})
    for name, ms, err, b_ms, b_by in (
            ("flash_attention_bwd_dq", dq_ms, dq_err, dq_bound, dq_by),
            ("flash_attention_bwd_dkv", dkv_ms, dkv_err, dkv_bound,
             dkv_by)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "paddle_tpu_torch/csrc/"
                                  "flash_attention_bwd.cu",
                        "replaces": "paddle_tpu/ops/pallas/flash_attention."
                                    + ("py:452" if name.endswith("dq")
                                       else "py:498"),
                        "launches": train_launches[name]
                        + fused_launches[name]
                        + sum(r["launches"][name]
                              for r in (*remat_runs.values(),
                                        *longseq.values()))
                        + sum(r["unpadded"]["launches"][
                            "launches_" + name.rsplit("_", 1)[1]]
                            for r in (bert_runs, bert_plain))
                        + mflash_launches[
                            "launches_" + name.rsplit("_", 1)[1]]
                        + eager_launch[name],
                        "max_abs_err": err, "ms": ms,
                        # the plain version and the library call compute
                        # dq, dk and dv in one call: the pair's work
                        "plain_ms": bwd_plain, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": bwd_lib})
    del qt, kt, vt, q4, k4, v4, ql, kl, vl, out_l, dot, ot, lse, delta

    n, hd, v = B * S, cfg.hidden_size, cfg.vocab_size
    h = rand(g, (n, hd), bf16)
    w = w_head
    ce_ms = cuda_ms(lambda: fused_ce._launch(h, w), reps=5)
    ce_plain = cuda_ms(lambda: fused_ce.ce_logz_reference(h, w), reps=3)
    ce_lib = cuda_ms(lambda: torch.logsumexp(h @ w.T, -1), reps=5)
    ce_bound, ce_by = bound(2 * n * v * hd, (n * hd + v * hd) * 2 + n * 4,
                            PEAK_BF16_FLOPS)
    table.append({"kernel": "fused_ce_fwd",
                  "shape": f"n={n} h={hd} v={v} bf16",
                  "kernel_ms": ce_ms, "plain_ms": ce_plain,
                  "library_ms": ce_lib, "bound_ms": ce_bound,
                  "launches_per_forward": 1})
    kernels.append({"name": "fused_ce_fwd", "route": "cuda",
                    "source": "paddle_tpu_torch/csrc/fused_ce_fwd.cu",
                    "replaces": "paddle_tpu/ops/pallas/fused_ce.py:79",
                    "launches": serve_launches["fused_ce_fwd"]
                    + fused_launches["fused_ce_fwd"],
                    "max_abs_err": ce_err, "ms": ce_ms, "plain_ms": ce_plain,
                    "bound_ms": ce_bound, "bound_by": ce_by,
                    "library_ms": ce_lib})

    # backward: one call computes dh and dW (three passes a vocabulary
    # chunk); the plain backward and the library's three products each
    # compute both.  Each pass's device time comes from the profiler.
    logz = fused_ce._launch(h, w)
    gv = torch.randn(n, generator=g, device="cuda") / n
    gv[S - 1::S] = 0.0                       # the sentinel of each sequence
    pair_ms = cuda_ms(lambda: fused_ce._launch_bwd(h, w, logz, gv), reps=5)
    pass_ms = ce_bwd_pass_ms(lambda: fused_ce._launch_bwd(h, w, logz, gv))
    bwd_plain = cuda_ms(lambda: fused_ce.ce_bwd_reference(h, w, logz, gv),
                        reps=3)

    def ce_bwd_library():
        p = (torch.softmax((h @ w.T).float(), -1) * gv[:, None]).to(bf16)
        return p @ w, p.T @ h

    ce_bwd_lib = cuda_ms(ce_bwd_library, reps=3)
    prod = 2 * n * v * hd                    # one product
    io = (n * hd + v * hd) * 2 + 2 * n * 4   # h, W, logz, g
    # dh's row holds the P pass (the scores) and the dh pass: 2 products;
    # dW's row the dW pass: 1 product, reading h and writing dW.  The two
    # rows' times and bounds sum to the pair's.
    dh_bound, dh_by = bound(2 * prod, io + n * hd * 2, PEAK_BF16_FLOPS)
    dw_bound, dw_by = bound(prod, (n * hd + v * hd) * 2, PEAK_BF16_FLOPS)
    ce_pair_bound, ce_pair_by = bound(3 * prod, io + (n + v) * hd * 2,
                                      PEAK_BF16_FLOPS)
    dh_ms = pass_ms["p"] + pass_ms["dh"]
    dw_ms = pass_ms["dw"]
    vc = fused_ce.chunk_width(n, v)
    table.append({"kernel": "fused_ce_bwd (dh + dW)",
                  "shape": f"n={n} h={hd} v={v} bf16, {-(-v // vc)} chunks "
                           f"of {vc}",
                  "kernel_ms": pair_ms, "p_pass_ms": pass_ms["p"],
                  "dw_pass_ms": pass_ms["dw"], "dh_pass_ms": pass_ms["dh"],
                  "pass_bound_ms": bound(prod, 0, PEAK_BF16_FLOPS)[0],
                  "plain_ms": bwd_plain, "library_ms": ce_bwd_lib,
                  "bound_ms": ce_pair_bound, "bound_by": ce_pair_by,
                  "launches_per_step": MICRO})
    for name, ms, err, b_ms, b_by, line in (
            ("fused_ce_bwd_dh", dh_ms, dh_err, dh_bound, dh_by, 138),
            ("fused_ce_bwd_dw", dw_ms, dw_err, dw_bound, dw_by, 161)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "paddle_tpu_torch/csrc/fused_ce_bwd.cu",
                        "replaces": f"paddle_tpu/ops/pallas/fused_ce.py:{line}",
                        "launches": fused_launches[name],
                        "max_abs_err": err, "ms": ms,
                        # the plain version and the library call compute
                        # dh and dW in one call: the pair's work
                        "plain_ms": bwd_plain, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": ce_bwd_lib})
    del h, logz, gv

    table.append({"kernel": "fused_adam",
                  "shape": f"{n_params} f32 elements in 16 tensors",
                  "kernel_ms": adam_ms, "plain_ms": adam_plain,
                  "library_ms": adam_lib, "bound_ms": adam_bound,
                  "bound_by": adam_by,
                  "launches_per_step": per_step[-1]})
    kernels.append({"name": "fused_adam", "route": "cuda",
                    "source": "paddle_tpu_torch/csrc/fused_adam.cu",
                    "replaces": "paddle_tpu/ops/pallas/fused_adam.py:47",
                    "launches": fused_launches["fused_adam"],
                    "max_abs_err": adam_err, "ms": adam_ms,
                    "plain_ms": adam_plain, "bound_ms": adam_bound,
                    "bound_by": adam_by, "library_ms": adam_lib})
    # the bf16 instantiation at GPT-2 345M's 16 stacked tensors: reads p,
    # g, m, v and writes p, m, v in bf16, 14 bytes and 11 f32 operations a
    # value; the yardstick is torch.optim.AdamW(fused=True) over bf16
    # parameters (another formula: a time only)
    a16_n, (a_p, a_g, a_m, a_v, a_args) = check_adam_bf16(
        g, fused_adam, AdamW, adam_shapes, faults=False)
    a16_ms = cuda_ms(lambda: fused_adam._launch(a_p, a_g, a_m, a_v,
                                                *a_args))
    a16_plain = cuda_ms(lambda: fused_adam.fused_adam_reference(
        a_p, a_g, a_m, a_v, *a_args), reps=3)
    a16_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        fused_adam._launch(a_p, a_g, a_m, a_v, *a_args)[0],
        fused_adam.fused_adam_reference(a_p, a_g, a_m, a_v, *a_args)[0]))
    lib_params = [p.detach().clone().requires_grad_() for p in a_p]
    for lp, gr in zip(lib_params, a_g):
        lp.grad = gr
    lib_opt = torch.optim.AdamW(lib_params, lr=LR_PEAK, weight_decay=0.01,
                                fused=True)
    a16_lib = cuda_ms(lib_opt.step)
    a16_bound, a16_by = bound(11 * a16_n, 14 * a16_n, PEAK_F32_FLOPS)
    del lib_params, lib_opt, a_p, a_g, a_m, a_v
    torch.cuda.empty_cache()
    table.append({"kernel": "fused_adam_bf16",
                  "shape": f"{a16_n} bf16 elements in 16 tensors",
                  "kernel_ms": a16_ms, "plain_ms": a16_plain,
                  "library_ms": a16_lib, "bound_ms": a16_bound,
                  "bound_by": a16_by, "launches_per_step": 1,
                  "f32_kernel_ms": adam_ms})
    kernels.append({"name": "fused_adam_bf16", "route": "cuda",
                    "source": "paddle_tpu_torch/csrc/fused_adam.cu",
                    "replaces": "paddle_tpu/ops/pallas/fused_adam.py:47",
                    "launches": eager_launch["fused_adam_bf16"],
                    "max_abs_err": a16_err, "ms": a16_ms,
                    "plain_ms": a16_plain, "bound_ms": a16_bound,
                    "bound_by": a16_by, "library_ms": a16_lib})

    # the row quantizer #9 on GPT-2 345M's gradient in 256-wide rows: reads
    # 4 B a value, writes 1 B (int8) or 0.5 B (int4) a value and 4 B a row.
    # No one PyTorch call computes the codec: no library time.
    nq, rq_n = grows.numel(), grows.shape[0]
    for wire, out_b, launches in (
            ("int8", 1.0, zero_launch["int8"]),
            ("int4", 0.5, zero_launch["int4"] + zero_launch["int4-ring"])):
        q_ms = cuda_ms(lambda: ring_quant._launch(grows, wire))
        q_plain = cuda_ms(lambda: ring_quant.ring_quant_rows_reference(
            grows, wire), reps=3)
        q_bound, q_by = bound(5 * nq, (4 + out_b) * nq + 4 * rq_n,
                              PEAK_F32_FLOPS)
        table.append({"kernel": f"ring_quant {wire}",
                      "shape": f"{rq_n} rows x 256 f32 (GPT-2 345M's "
                               "gradient)",
                      "kernel_ms": q_ms, "plain_ms": q_plain,
                      "library_ms": None, "bound_ms": q_bound,
                      "bound_by": q_by,
                      "launches_per_step": 2 * ZERO_LEAVES})
        kernels.append({"name": f"ring_quant_{wire}", "route": "cuda",
                        "source": "paddle_tpu_torch/csrc/ring_quant.cu",
                        "replaces": "paddle_tpu/ops/pallas/ring_quant.py:51",
                        "launches": launches, "max_abs_err": quant_err,
                        "ms": q_ms, "plain_ms": q_plain, "bound_ms": q_bound,
                        "bound_by": q_by, "library_ms": None})
    del grows

    # BERT-base's attention layer (B*H = 128*12, S = 128, D = 64, bf16,
    # non-causal): #1-#3 with the padding bias and without a mask, #4 in
    # the learned-bias encoder's (1, H, S, S) class.  The work counted for
    # a bound is what this run's data needs: with the padding bias, the
    # (query, key) pairs whose key is a real token.
    bbh = BERT_B * BERT_HEADS
    bq, bk, bv, bdo = (rand(g, (bbh, BERT_S, 64), bf16) for _ in range(4))
    bsc = 0.125
    q4b, k4b, v4b, do4b = (t.view(BERT_B, BERT_HEADS, BERT_S, 64)
                           for t in (bq, bk, bv, bdo))
    pmask = fa.Mask(padding_bias(b_amask), None, None, BERT_HEADS)
    lib_keep = b_amask.bool()[:, None, None, :]
    tb = bbh * BERT_S * 64 * 2                   # one bf16 tensor
    rb = bbh * BERT_S * 4                        # one f32 row vector
    pbb = BERT_B * BERT_S * 4                    # the f32 padding bias
    bert_att = {}
    for kind, mask, keep, pairs in (
            ("masked", pmask, lib_keep, BERT_HEADS * BERT_S * real),
            ("unmasked", None, None, bbh * BERT_S * BERT_S)):
        extra = pbb if mask is not None else 0
        prod = 2 * 64 * pairs                    # one product
        r = {"fwd_ms": cuda_ms(lambda: fa._launch(bq, bk, bv, bsc, False,
                                                  mask)),
             "fwd_plain_ms": cuda_ms(lambda: fa.flash_attention_reference(
                 bq, bk, bv, bsc, False, mask), reps=3),
             "fwd_library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                 q4b, k4b, v4b, attn_mask=keep, scale=bsc))}
        ot_b, lse_b = fa._launch(bq, bk, bv, bsc, False, mask)
        delta_b = fa._delta(bdo, ot_b)
        r["dq_ms"] = cuda_ms(lambda: fa._launch_dq(bq, bk, bv, bdo, lse_b,
                                                   delta_b, bsc, False, mask))
        r["dkv_ms"] = cuda_ms(lambda: fa._launch_dkv(
            bq, bk, bv, bdo, lse_b, delta_b, bsc, False, mask))
        r["bwd_plain_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_reference(
            bq, bk, bv, ot_b, lse_b, bdo, bsc, False, mask), reps=3)
        ql, kl, vl = (t.detach().clone().requires_grad_()
                      for t in (q4b, k4b, v4b))
        out_l = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=keep,
                                               scale=bsc)
        r["bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            out_l, (ql, kl, vl), do4b, retain_graph=True))
        r["fwd_bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(ql, kl, vl, attn_mask=keep,
                                           scale=bsc), (ql, kl, vl), do4b))
        # forward: reads q, k, v (and the bias), writes out and lse
        r["fwd_bound"] = bound(2 * prod, 4 * tb + rb + extra,
                               PEAK_BF16_FLOPS)
        # dq: reads q, k, v, do, lse, delta, writes dq: 3 products
        r["dq_bound"] = bound(3 * prod, 5 * tb + 2 * rb + extra,
                              PEAK_BF16_FLOPS)
        # dk/dv: reads q, k, v, do, lse, delta, writes dk, dv: 4 products
        r["dkv_bound"] = bound(4 * prod, 6 * tb + 2 * rb + extra,
                               PEAK_BF16_FLOPS)
        bert_att[kind] = r
        row = {"kernel": f"flash_attention {kind} (fwd, dq, dk/dv)",
               "shape": f"bh={bbh} s={BERT_S} d=64 bf16 non-causal"
               + (f", bias {BERT_B}x1x1x{BERT_S} f32 padding, {real} real "
                  "tokens" if mask is not None else "")}
        for k, v in r.items():
            if isinstance(v, tuple):
                row[k + "_ms"], row[k + "_by"] = v
            else:
                row[k] = v
        table.append(row)
        del ot_b, lse_b, delta_b, ql, kl, vl, out_l

    lmask = fa.Mask(rand(g, (1, BERT_HEADS, BERT_S, BERT_S), bf16), None,
                    None, BERT_HEADS)
    ot_l, lse_l = fa._launch(bq, bk, bv, bsc, False, lmask)
    delta_l = fa._delta(bdo, ot_l)
    db_ms = cuda_ms(lambda: fa._launch_dbias(bq, bk, bv, bdo, lse_l, delta_l,
                                             bsc, False, lmask))
    db_plain = cuda_ms(lambda: fa.flash_attention_dbias_reference(
        bq, bk, bv, ot_l, lse_l, bdo, bsc, False, lmask), reps=3)
    ql, kl, vl = (t.detach().clone().requires_grad_()
                  for t in (q4b, k4b, v4b))
    ml = lmask.bias.detach().clone().requires_grad_()
    out_m = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=ml,
                                           scale=bsc)
    db_lib = cuda_ms(lambda: torch.autograd.grad(out_m, (ml,), do4b,
                                                 retain_graph=True))
    db_fb_lib = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(ql, kl, vl, attn_mask=ml, scale=bsc),
        (ql, kl, vl, ml), do4b))
    lbb = BERT_HEADS * BERT_S * BERT_S * 2       # the bf16 bias
    # dbias: reads q, k, v, do, lse, delta and the bias, writes dbias:
    # 2 products (s and dp) over every pair
    db_bound, db_by = bound(2 * 2 * 64 * bbh * BERT_S * BERT_S,
                            4 * tb + 2 * rb + 2 * lbb, PEAK_BF16_FLOPS)
    table.append({"kernel": "flash_attention_dbias",
                  "shape": f"bias 1x{BERT_HEADS}x{BERT_S}x{BERT_S} bf16 "
                           f"over bh={bbh}, d=64 bf16",
                  "kernel_ms": db_ms, "plain_ms": db_plain,
                  "library_ms": db_lib, "fwd_bwd_library_ms": db_fb_lib,
                  "bound_ms": db_bound, "bound_by": db_by,
                  "launches_per_step": BL})
    del ot_l, lse_l, delta_l, ql, kl, vl, ml, out_m

    # the flash kernel against the dense path on BERT-base's layer, at the
    # public (B, S, H, D) functions with the padding bias: the card's own
    # reading of the crossover the reference set on the TPU
    qp, kp, vp, dop = (t.permute(0, 2, 1, 3) for t in (q4b, k4b, v4b, do4b))
    pb = padding_bias(b_amask)
    with torch.inference_mode():
        layer_flash = cuda_ms(lambda: fa.flash_attention(qp, kp, vp,
                                                         scale=bsc, bias=pb))
        layer_dense = cuda_ms(lambda: _xla_attention(qp, kp, vp, pb, bsc,
                                                     False))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (qp, kp, vp))
    layer_flash_fb = cuda_ms(lambda: torch.autograd.grad(
        fa.flash_attention(qg, kg, vg, scale=bsc, bias=pb), (qg, kg, vg),
        dop))
    layer_dense_fb = cuda_ms(lambda: torch.autograd.grad(
        _xla_attention(qg, kg, vg, pb, bsc, False), (qg, kg, vg), dop))
    del bq, bk, bv, bdo, q4b, k4b, v4b, do4b, qg, kg, vg

    # #1-#3 at the seq2seq path's three mask shapes, the biases in bf16 as
    # TrainStep's O2 cast gives them.  The work counted for a bound: under
    # a bias row the pairs whose key is real; under the full causal bias
    # every pair, since the kernels walk every key tile; and the same
    # decoder self-attention through the unmasked causal kernel beside it
    real_src = int((s2s_bias == 0).sum())
    row_b = s2s_bias.to(bf16)
    keep_s = (s2s_bias == 0)
    causal_b = tnn.Transformer.generate_square_subsequent_mask(
        S2S_TGT).to(bf16).view(1, 1, S2S_TGT, S2S_TGT)
    s2s_att = {}
    for name, sq, sk, bias_t, sdpa_m, pairs in (
            ("cross", S2S_TGT, S2S_SRC, row_b, keep_s,
             S2S_HEADS * S2S_TGT * real_src),
            ("decoder_self", S2S_TGT, S2S_TGT, causal_b, causal_b,
             S2S_B * S2S_HEADS * S2S_TGT * S2S_TGT),
            ("encoder", S2S_SRC, S2S_SRC, row_b, keep_s,
             S2S_HEADS * S2S_SRC * real_src)):
        s2s_att[name] = masked_times(
            g, fa, F, S2S_B, S2S_HEADS, sq, sk, 64,
            fa.Mask(bias_t.contiguous(), None, None, S2S_HEADS), sdpa_m,
            pairs, bias_t.numel() * 2)
    s2s_att["decoder_self_is_causal"] = masked_times(
        g, fa, F, S2S_B, S2S_HEADS, S2S_TGT, S2S_TGT, 64, None, None,
        S2S_B * S2S_HEADS * visible_pairs(S2S_TGT, S2S_TGT, True), 0,
        causal=True)
    for name, r in s2s_att.items():
        table.append({"kernel": f"flash_attention seq2seq {name} (fwd, dq, "
                                "dk/dv)",
                      "shape": f"b={S2S_B} h={S2S_HEADS} d=64 bf16, "
                               f"{real_src} real source keys", **r})

    m_launch = {n: bserve_launches[n] + bert_runs["padded"]["launches"][n]
                + bert_plain["padded"]["launches"][n] + enc_launches[n]
                + mflash_launches[n] + s2s_launch[n] + serve_launch[n]
                for n in FA_COUNTERS}
    ma = bert_att["masked"]
    m_errs = [max(a, b) for a, b in zip(m_errs, s2s_err)]
    for name, counter, src, line, ms, err, bnd, plain, lib in (
            ("flash_attention_fwd_masked", "launches_masked", "fwd", 190,
             ma["fwd_ms"], m_errs[0], ma["fwd_bound"], ma["fwd_plain_ms"],
             ma["fwd_library_ms"]),
            ("flash_attention_bwd_dq_masked", "launches_dq_masked", "bwd",
             452, ma["dq_ms"], m_errs[1], ma["dq_bound"],
             ma["bwd_plain_ms"], ma["bwd_library_ms"]),
            ("flash_attention_bwd_dkv_masked", "launches_dkv_masked", "bwd",
             498, ma["dkv_ms"], m_errs[2], ma["dkv_bound"],
             ma["bwd_plain_ms"], ma["bwd_library_ms"]),
            ("flash_attention_dbias", "launches_dbias", "dbias", 560, db_ms,
             dbias_err, (db_bound, db_by), db_plain, db_lib)):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"paddle_tpu_torch/csrc/"
                                  f"flash_attention_{src}.cu",
                        "replaces": f"paddle_tpu/ops/pallas/flash_attention"
                                    f".py:{line}",
                        "launches": m_launch[counter], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
                        "bound_by": bnd[1], "library_ms": lib})
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"{k['name']} was launched no time on the main path")

    # -- 24. transforms-resnet50 --------------------------------------------
    # -- 25. dcgan ----------------------------------------------------------
    # -- 26. nn-breadth -----------------------------------------------------
    # no hand-written kernel lies on these paths; the launch counters stay
    # as the main path left them
    clock.begin(24, "transforms-resnet50")
    dense_row = transforms_resnet50(T, resnet50, TrainStep, Momentum, power)
    clock.begin(25, "dcgan")
    dense_row.update(dcgan_phase(tnn, topt, power))
    clock.begin(26, "nn-breadth")
    dense_row["nn_breadth"] = nn_breadth(tnn.functional, power)

    # -- 27. resnet50-gn ----------------------------------------------------
    # -- 28. sn-dcgan -------------------------------------------------------
    # -- 29. sparse-embedding -----------------------------------------------
    # -- 30. norm-breadth and rnn-amp ---------------------------------------
    # the Layer slice: no hand-written kernel lies on these paths either
    clock.begin(27, "resnet50-gn")
    layer_row = {"resnet50_gn": resnet50_gn_phase(
        tnn, tnn.functional, resnet18, resnet50, TrainStep, Momentum, power,
        r_ms)}
    clock.begin(28, "sn-dcgan")
    layer_row["sn_dcgan"] = sn_dcgan_phase(tnn, topt, power,
                                           dense_row["dcgan_iteration_ms"])
    clock.begin(29, "sparse-embedding")
    layer_row["sparse_embedding"] = sparse_embedding_phase(
        tnn, topt, SelectedRows, power)
    clock.begin(30, "norm-breadth and rnn-amp")
    layer_row["norm_breadth"] = norm_breadth(tnn, tnn.functional, power)
    layer_row["rnn_amp"] = rnn_amp_phase(tnn, amp, power)

    # -- 31. yolov3-dcn train -----------------------------------------------
    # -- 32. yolov3-dcn serve -----------------------------------------------
    # -- 33. det-ops --------------------------------------------------------
    # vision.ops: no hand-written kernel lies on these paths either
    clock.begin(31, "yolov3-dcn train")
    yolo, yolo_train = yolov3_train_phase(tnn, tnn.functional, vops,
                                          resnet18, resnet50, Momentum,
                                          regularizer.L2Decay, power)
    small = yolo_train["small"]
    clock.begin(32, "yolov3-dcn serve")
    det_row = {"yolov3_dcn_train": yolo_train,
               "yolov3_dcn_serve": yolov3_serve_phase(
                   vops, yolo, power, small, lambda: yolov3_dcn(
                       tnn, tnn.functional, vops, resnet50, YOLO_CLASSES))}
    del yolo
    clock.begin(33, "det-ops")
    det_row["det_ops"] = det_ops_phase(vops, power)

    # -- 34. faster-rcnn train ----------------------------------------------
    # -- 35. faster-rcnn serve ----------------------------------------------
    # -- 36. det-tail -------------------------------------------------------
    # vision.ops' second half: no hand-written kernel lies on these paths
    clock.begin(34, "faster-rcnn train")
    frcnn, last, frcnn_gts, det_row["faster_rcnn_train"] = frcnn_train_phase(
        tnn, tnn.functional, vops, resnet18, resnet50, Momentum,
        regularizer.L2Decay, topt.lr.LinearWarmup, power)
    clock.begin(35, "faster-rcnn serve")
    det_row["faster_rcnn_serve"] = frcnn_serve_phase(vops, tnn.functional,
                                                     frcnn, power)
    del frcnn
    torch.cuda.empty_cache()
    clock.begin(36, "det-tail")
    det_row["det_tail"] = det_tail_phase(vops, power, last, frcnn_gts)

    # -- 37. gpt-eval ---------------------------------------------------------
    # -- 38. tensor-probe -----------------------------------------------------
    # the tensor library: no hand-written kernel lies on these paths
    clock.begin(37, "gpt-eval")
    tensor_row = {}
    # phase 3's GPT-2 345M in bf16, built once for phases 37, 39 and 40
    t0 = time.perf_counter()
    gpt_bf16 = GPT(cfg, device="cuda").to(bf16)
    log(f"gpt-eval: GPT-2 345M built in bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    tensor_row["gpt_eval"], hidden, wte, eval_ids = gpt_eval_phase(
        ttensor, gpt_bf16, cfg, gpt_loss, set_flags, final_hidden, power)
    clock.begin(38, "tensor-probe")
    tensor_row["tensor_probe"] = tensor_probe_phase(
        ttensor, Constant, hidden, wte, eval_ids, power)
    del hidden, wte

    # -- 39. gpt-checkpoint ---------------------------------------------------
    # -- 40. gpt-sample -------------------------------------------------------
    # -- 41. bert-ragged and breadth ------------------------------------------
    # the tensor library's second half and the top-level namespace; each
    # phase sets the counters to 0 and reads them, and its launches join
    # the kernel table's
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.framework import io as tio
    second_row = {}
    clock.begin(39, "gpt-checkpoint")
    second_row["gpt_checkpoint"], ck_launch = gpt_checkpoint_phase(
        gpt_bf16, gpt_loss, amp, AdamW, topt.lr.CosineAnnealingDecay, fa,
        fused_adam, ids_t, tio, power)
    clock.begin(40, "gpt-sample")
    second_row["gpt_sample"], sample_launch = gpt_sample_phase(
        tpt, tnn.functional, gpt_bf16, fa, power)
    clock.begin(41, "bert-ragged and breadth")
    second_row["bert_ragged"], ragged_launch = bert_ragged_phase(
        tpt, Bert, bert_base, fa, power)
    for k in kernels:
        for extra in (ck_launch, sample_launch, ragged_launch):
            k["launches"] += extra.get(k["name"], 0)
    log(f"second-half phases (39-41): launches {ck_launch}, "
        f"{sample_launch}, {ragged_launch}")

    # -- 42. int8-resnet18 ----------------------------------------------------
    # -- 43. gpt-deploy -------------------------------------------------------
    # -- 44. capture-breadth --------------------------------------------------
    # static capture and deployment: #1-#7 run as custom ops inside the
    # captured and loaded graphs; each phase sets the counters to 0 and
    # reads them, and its launches join the kernel table's
    from paddle_tpu_torch import inference, quantization, static
    from paddle_tpu_torch import jit as tjit
    from paddle_tpu_torch.framework import crypto
    clock.begin(42, "int8-resnet18")
    deploy_row = {"int8_resnet18": int8_resnet18_phase(
        resnet18, tjit, quantization, power)}
    clock.begin(43, "gpt-deploy")
    deploy_row["gpt_deploy"], deploy_launch = gpt_deploy_phase(
        gpt_bf16, tnn, gpt_loss, set_flags, fa, fused_ce, tjit,
        static.InputSpec, inference, power)
    del gpt_bf16
    torch.cuda.empty_cache()
    clock.begin(44, "capture-breadth")
    deploy_row["capture_breadth"], breadth_launch = capture_breadth_phase(
        tpt, tnn, tjit, static, inference, crypto, fa, fused_ce, power)
    captured = {}
    for extra in (deploy_launch, breadth_launch):
        for name, n in extra.items():
            captured[name] = captured.get(name, 0) + n
    for k in kernels:
        k["launches"] += captured.get(k["name"], 0)
        k["captured_launches"] = captured.get(k["name"], 0)
    missing = [n for n in CAPTURE_KERNELS if captured.get(n, 0) <= 0]
    if missing:
        fail(f"{missing} launched no time inside a captured or loaded graph")
    log(f"deployment phases (42-44): launches inside captured and loaded "
        f"graphs {captured}")

    # -- 45. fleet-gpt --------------------------------------------------------
    # -- 46. dp-meta ----------------------------------------------------------
    # -- 47. syncbn -----------------------------------------------------------
    # data parallelism's user surface: fleet, ShardedTrainStep's stages,
    # LocalSGD, DGC, SyncBatchNorm; #1-#3 run under every GPT step, each
    # phase sets the counters to 0 and reads them, and its launches join
    # the kernel table's
    dp_row = {}
    clock.begin(45, "fleet-gpt")
    dp_row["fleet_gpt"], fleet_launch = fleet_gpt_phase(
        cfg, ids_t, fa, train_row["train_losses"], train_final, power)
    del train_final
    clock.begin(46, "dp-meta")
    dp_row["dp_meta"], meta_launch = dp_meta_phase(cfg, ids_t, fa, power)
    clock.begin(47, "syncbn")
    dp_row["syncbn"] = syncbn_phase(resnet18, resnet50, power)
    for k in kernels:
        for extra in (fleet_launch, meta_launch):
            k["launches"] += extra.get(k["name"], 0)
    log(f"data-parallel phases (45-47): launches {fleet_launch}, "
        f"{meta_launch}")

    # -- 48. tp-gpt -----------------------------------------------------------
    # -- 49. sp-ring ----------------------------------------------------------
    # tensor and sequence parallelism: GPT-2 345M's width at PAR_LAYERS
    # layers at mp = 2 and sp = 2, the ring on #1-#3 at S = 8192; each run
    # sets the counters to 0 and reads them, and its launches join the
    # kernel table's (tp_sp_launches)
    clock.begin(48, "tp-gpt")
    pcfg = gpt2_345m(max_seq_len=S, remat=False)
    pcfg.num_layers = PAR_LAYERS
    tp_base = GPT(pcfg, device="cuda")                # f32, seed 0
    tp_losses, tp_ref = one_rank_o2(tp_base, ids_t)
    tp_sp_row = {}
    tp_sp_row["tp_gpt"], tp_launch = tp_gpt_phase(
        tp_base, pcfg, ids_t, fa, tp_losses, tp_ref, power)
    clock.begin(49, "sp-ring")
    tp_sp_row["sp_ring"], ring_launch = sp_ring_phase(
        tp_base, pcfg, ids_t, fa, tp_losses, tp_ref, power)
    for k in kernels:
        extra = tp_launch.get(k["name"], 0) + ring_launch.get(k["name"], 0)
        k["launches"] += extra
        k["tp_sp_launches"] = extra
    log(f"tensor and sequence parallel phases (48-49): launches "
        f"{tp_launch}, {ring_launch}")

    # -- 50. pp-gpt -----------------------------------------------------------
    clock.begin(50, "pp-gpt")
    # the pipeline: the same at pp = 2 and 4 in both schedules, with mp,
    # dp and sp at 2 layers; its runs set the counters to 0 and read them,
    # and its launches join the kernel table's (pp_launches)
    tp_sp_row["pp_gpt"], pp_launch = pp_gpt_phase(
        tp_base, pcfg, ids_t, fa, tp_losses, tp_ref, power)
    del tp_base, tp_ref
    torch.cuda.empty_cache()
    for k in kernels:
        k["launches"] += pp_launch.get(k["name"], 0)
        k["pp_launches"] = pp_launch.get(k["name"], 0)
    log(f"pipeline phase (50): launches {pp_launch}")

    # -- 51. bert-mp ----------------------------------------------------------
    # -- 52. widedeep ---------------------------------------------------------
    # -- 53. widedeep-ps ------------------------------------------------------
    # -- 54. widedeep-device --------------------------------------------------
    # BERT's mp path, then the parameter server's tiers; bert-mp's runs set
    # the counters to 0 and read them, and its launches of #1-#3 join the
    # kernel table's (bert_mp_launches); no kernel lies on the PS tiers
    ps_row = {}
    clock.begin(51, "bert-mp")
    ps_row["bert_mp"], bmp_launch = bert_mp_phase(fa, fused_ce, power)
    for k in kernels:
        k["launches"] += bmp_launch.get(k["name"], 0)
        k["bert_mp_launches"] = bmp_launch.get(k["name"], 0)
    log(f"bert-mp phase (51): launches {bmp_launch}")
    clock.begin(52, "widedeep")
    ps_row["widedeep"] = widedeep_phase(power)
    clock.begin(53, "widedeep-ps")
    ps_row["widedeep_ps"], ps_keep = widedeep_ps_phase(power)
    # phase 57's server draws its table while phases 54-56 run
    remote_server = start_remote_server()
    clock.begin(54, "widedeep-device")
    ps_row["widedeep_device"] = widedeep_device_phase(power)

    # -- 55. planes -----------------------------------------------------------
    # the host planes on GPT-2 345M's O2 TrainStep: spans, statistics,
    # compile site, memory gauge, the profiler's trace, no added
    # synchronisation; its runs set the counters to 0 and read them, and
    # its launches join the kernel table's (planes_launches)
    clock.begin(55, "planes")
    ps_row["planes"], pl_launch = planes_phase(cfg, ids_t, fa, power)
    for k in kernels:
        k["launches"] += pl_launch.get(k["name"], 0)
        k["planes_launches"] = pl_launch.get(k["name"], 0)

    # -- 56. widedeep-filefed -------------------------------------------------
    # -- 57. widedeep-remote --------------------------------------------------
    # -- 58. graph ------------------------------------------------------------
    # the PS transport, the datasets over the native datafeed and the graph
    # table; no kernel lies on them.  Phase 53's step and its 26.4 GB table
    # train on in 56 and are dropped before 57 begins; 57's server has
    # drawn its own table since before 54 (the host holds both meanwhile)
    clock.begin(56, "widedeep-filefed")
    ps_row["widedeep_filefed"] = widedeep_filefed_phase(
        power, ps_keep, ps_row["widedeep_ps"])
    del ps_keep
    gc.collect()
    clock.begin(57, "widedeep-remote")
    ps_row["widedeep_remote"] = widedeep_remote_phase(
        power, ps_row["widedeep_ps"], remote_server)
    clock.begin(58, "graph")
    ps_row["graph"] = graph_phase(power)

    # -- 59. resnet50-filefed -------------------------------------------------
    # -- 60. gpt-durable ------------------------------------------------------
    # the data and state planes: the file-fed ResNet-50 through the ingest
    # pipeline (no kernel of the table lies on it), then GPT-2 345M's width
    # at DURABLE_LAYERS layers saved, restored and watched by numerics on
    # #1-#3; gpt-durable sets the flash counters to 0 and reads them, its
    # launches join the kernel table's (durable_launches)
    clock.begin(59, "resnet50-filefed")
    ps_row["resnet50_filefed"] = resnet50_filefed_phase(power)
    clock.begin(60, "gpt-durable")
    dcfg = gpt2_345m(max_seq_len=S, remat=False)
    dcfg.num_layers = DURABLE_LAYERS
    ps_row["gpt_durable"], dur_launch = gpt_durable_phase(dcfg, fa, power)
    for k in kernels:
        k["launches"] += dur_launch.get(k["name"], 0)
        k["durable_launches"] = dur_launch.get(k["name"], 0)
    log(f"gpt-durable phase (60): launches {dur_launch}")

    # -- 61. resilient-gpt ----------------------------------------------------
    # -- 62. parity-numerics --------------------------------------------------
    # -- 63. ops-planes -------------------------------------------------------
    # the operations planes: ResilientTrainStep with the incident ring, its
    # replay, the run ledger, blame and the collector on bench_gpt2_345m's
    # step; the parity probe at dp = 2 and numerics under ShardedTrainStep
    # at mp = 2; the elastic agent and the launcher (phase 63's autopilot leg
    # ran inside phase 57).  61 and 62 set the flash counters to 0 and read
    # them; their launches join the kernel table's (ops_launches)
    ops_row = {}
    clock.begin(61, "resilient-gpt")
    ops_row["resilient_gpt"], res_launch = resilient_gpt_phase(
        fa, power, ps_row["planes"])
    clock.begin(62, "parity-numerics")
    ops_row["parity_numerics"], par_launch = parity_numerics_phase(
        cfg, ids_t, fa, power)
    clock.begin(63, "ops-planes")
    ops_row["ops_planes"] = elastic_phase(fa, power)
    clock.end()
    ops_row["ops_planes"]["autopilot"] = ps_row["widedeep_remote"].get(
        "autopilot")
    for k in kernels:
        extra = res_launch.get(k["name"], 0) + par_launch.get(k["name"], 0)
        k["launches"] += extra
        k["ops_launches"] = extra
    log(f"operations plane phases (61-62): launches {res_launch}, "
        f"{par_launch}")
    for row in table:
        log(json.dumps(row))

    log(json.dumps({
        "forward_ms": fwd_ms, "forward_tokens_per_s": B * S / fwd_ms * 1e3,
        "attention_share_of_forward": L * fa_ms / fwd_ms,
        "loss_unfused_ms": unfused_ms, "loss_fused_ms": fused_ms,
        "loss_unfused_peak_bytes": unfused_mem,
        "loss_fused_peak_bytes": fused_mem, **train_row,
        "attention_bwd_share_of_train_step": L * (dq_ms + dkv_ms)
        / step_ms,
        "bert_serve_ms": bserve_ms,
        "bert_serve_tokens_per_s": BERT_B * BERT_S / bserve_ms * 1e3,
        "bert_serve_peak_bytes": bserve_mem,
        **{f"bert_train_{kind}_{k}": v for kind, run in bert_runs.items()
           for k, v in run.items() if k != "launches"},
        **{f"bert_train_remat_false_{kind}_{k}": v
           for kind, run in bert_plain.items()
           for k, v in run.items() if k not in ("launches", "losses")},
        **{f"remat[{form}]_{k}": v for form, run in remat_runs.items()
           for k, v in run.items() if k in ("step_ms", "tokens_per_s",
                                            "peak_bytes")},
        **{f"longseq_s{s_len}_{k}": v for s_len, run in longseq.items()
           for k, v in run.items() if k != "launches"},
        "gpt_longseq8k_flashattn_train_tokens_per_sec":
            longseq[LONG_S]["tokens_per_s"],
        "longseq_vs_baseline": long_ratio,
        "longseq_kernels": long_k,
        "longseq_check_max_abs_err": {str(k): list(v)
                                      for k, v in long_errs.items()},
        **{f"masked_flash_{k}": v for k, v in mflash.items()},
        "masked_flash_check_max_abs_err": list(mflash_err),
        "bert_padded_retention": retention,
        "bert_masked_attention_share_of_padded_step": BL * (
            ma["fwd_ms"] + ma["dq_ms"] + ma["dkv_ms"])
        / bert_runs["padded"]["step_ms"],
        "encoder_bias_step_ms": enc_ms,
        "encoder_bias_tokens_per_s": BERT_B * BERT_S / enc_ms * 1e3,
        "encoder_bias_peak_bytes": enc_mem, "encoder_bias_losses": enc_losses,
        "encoder_bias_dbias_share_of_step": BL * db_ms / enc_ms,
        "bert_layer_flash_fwd_ms": layer_flash,
        "bert_layer_dense_fwd_ms": layer_dense,
        "bert_layer_flash_fwd_bwd_ms": layer_flash_fb,
        "bert_layer_dense_fwd_bwd_ms": layer_dense_fb, **z["summary"],
        **vision_row,
        **{f"seq2seq_train_{k}": v for k, v in s2s_row.items()},
        **{f"seq2seq_serve_{k}": v for k, v in serve_row.items()},
        "seq2seq_small_err": s_err, "seq2seq_small_losses": s_falls,
        "seq2seq_check_max_abs_err": list(s2s_err),
        "seq2seq_attention": s2s_att, "rnn": rnn_rows,
        **eager_row,
        "eager_small_optimizer_err": opt_errs, **dense_row, **layer_row,
        **det_row, **tensor_row, **second_row, **deploy_row, **dp_row,
        "tp_sp_row": tp_sp_row, "bert_mp_ps_row": ps_row,
        "ops_row": ops_row,
        "phase_wall_s": {str(n): v for n, v in clock.seconds.items()},
        "chip_smoke_wall_s": time.perf_counter() - t_start}))

    log(card_power())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
